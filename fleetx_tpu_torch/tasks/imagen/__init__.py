"""Imagen tasks of the port (the cascade sampler)."""
