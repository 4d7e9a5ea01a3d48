"""Dense LM decode of the port (``repro/models/lm``'s counterpart): the
transformer pattern's config, layers, int8-KV decode attention and the
decode step."""
