"""Datasets of the port: the synthetic azobenzene MD set and the
synthetic token pipeline."""
