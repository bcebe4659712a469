"""Serving step builders of the port (``engine``)."""
