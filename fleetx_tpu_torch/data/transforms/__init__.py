"""Image transforms of the port."""
