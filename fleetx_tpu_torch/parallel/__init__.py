"""Parallel layout of the port: the auto-layout planner."""
