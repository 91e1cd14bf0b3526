"""Serving facade of the port (``train/server.py``), named as in ``repro``."""
