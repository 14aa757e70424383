"""PyTorch/CUDA port of fleetx_tpu, one slice at a time.

The JAX package ``fleetx_tpu`` is the reference; this package mirrors its
module paths (``fleetx_tpu_torch/serving/engine.py`` ↔
``fleetx_tpu/serving/engine.py``) so each counterpart is easy to find.
It imports ``torch`` and never ``jax`` or anything of ``fleetx_tpu``:
what it needs from a JAX-free module there, it keeps a copy of.

The slices so far: paged serving (``python -m
fleetx_tpu_torch.tools.serve``), GPT pretraining at seq 1024 and 8192
(``python -m fleetx_tpu_torch.tools.train``), checkpoints
(``core/checkpoint.py``, ``python -m fleetx_tpu_torch.tools.verify_ckpt``)
and text generation (``python -m fleetx_tpu_torch.tasks.gpt.generation``);
the hand-written Hopper kernels are in ``csrc/``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
