"""Datasets of the port (GPT pretraining so far)."""
