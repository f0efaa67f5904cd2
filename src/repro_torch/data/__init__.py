"""Data sources of the port."""
