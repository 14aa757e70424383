"""GPT tasks of the port (generation, inference over an export)."""
