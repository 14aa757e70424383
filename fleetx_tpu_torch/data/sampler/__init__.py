"""Batch samplers of the port."""
