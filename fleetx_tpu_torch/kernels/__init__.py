"""Build and load the hand-written CUDA kernels (``kernels/build.py``)."""
