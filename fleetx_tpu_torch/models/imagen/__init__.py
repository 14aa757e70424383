"""The Imagen family: the efficient U-Net, one cascade stage's diffusion
process and its training module."""
