"""PyTorch/CUDA port of fleetx_tpu, one slice at a time.

The JAX package ``fleetx_tpu`` is the reference; this package mirrors its
module paths (``fleetx_tpu_torch/serving/engine.py`` ↔
``fleetx_tpu/serving/engine.py``) so each counterpart is easy to find.
It imports ``torch`` and never ``jax`` or anything of ``fleetx_tpu``:
what it needs from a JAX-free module there, it keeps a copy of.

Slice 1 is paged serving (``python -m fleetx_tpu_torch.tools.serve``),
whose decode attention runs the hand-written Hopper kernel in
``csrc/paged_attention.cu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
