"""The LMs of the port (``repro/models/lm``'s counterpart): the config,
layers, attention (the q-chunked prefill and the KV-cache decode), the
MoE, Mamba2 (``ssm``) and xLSTM blocks, and their assembly into the
three block patterns (``transformer``)."""
