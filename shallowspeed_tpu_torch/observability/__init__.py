"""Observability for the port: so far the shared summary statistics."""
