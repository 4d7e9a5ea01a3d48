"""Measurement scripts of the port, run on the CPU as
``python -m repro_torch.tools.<name>``: the numbers that
``chip_smoke.py``'s bounds are derived from."""
