"""Prometheus metrics of the port (``registry.py``)."""
