"""Pending-pod queue for the port."""
