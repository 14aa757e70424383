"""The vision family: ViT, its losses and the classification module."""
