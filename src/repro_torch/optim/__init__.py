"""Optimizers of the port: AdamW and the cosine schedule."""
