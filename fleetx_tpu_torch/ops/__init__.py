"""Kernel-backed ops of the port (each beside its plain PyTorch version)."""
