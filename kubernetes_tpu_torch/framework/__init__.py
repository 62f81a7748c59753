"""Scheduler configuration for the port."""
