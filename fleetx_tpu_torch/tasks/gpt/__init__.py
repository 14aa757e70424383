"""GPT tasks of the port (generation)."""
