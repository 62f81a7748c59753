"""Host scheduler cache for the port."""
