"""Data sets of the port (numpy only)."""
