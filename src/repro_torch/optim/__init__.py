"""Optimizers of the port: AdamW, the cosine schedule and the
error-feedback gradient compression."""
