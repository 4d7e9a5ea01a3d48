"""Model-level weight quantization of the port (``repro/quant``)."""
