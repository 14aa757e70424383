"""Model families of the port (GPT so far)."""
