"""Interning, selector compilation and tensor packing for the port."""
