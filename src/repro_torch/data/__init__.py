"""Datasets of the port: the synthetic azobenzene MD set."""
