"""Resilience pieces the serving slice uses (the SIGTERM drain latch)."""
