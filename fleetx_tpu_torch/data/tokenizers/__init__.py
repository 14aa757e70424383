"""Tokenizers of the port (the GPT-2 byte-level BPE)."""
