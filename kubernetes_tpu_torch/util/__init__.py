"""Generic helpers for the port (the assume cache)."""
