"""PyTorch/CUDA port of fleetx_tpu, one slice at a time.

The JAX package ``fleetx_tpu`` is the reference; this package mirrors its
module paths (``fleetx_tpu_torch/serving/engine.py`` ↔
``fleetx_tpu/serving/engine.py``) so each counterpart is easy to find.
It imports ``torch`` and never ``jax`` or anything of ``fleetx_tpu``:
what it needs from a JAX-free module there, it keeps a copy of.

What it runs, on one card:

- serving: the paged replica (``python -m fleetx_tpu_torch.tools.serve``,
  int8 fake-quant and LoRA-merged weights included), one replica over a
  mesh of ranks (``tools.supervise --num-procs N``: pages over fsdp,
  heads and the Megatron splits over tensor; ``parallel/mesh.py``,
  ``utils/env.py``), the request router over replicas (``--router``) and
  the elastic supervisor
  (``python -m fleetx_tpu_torch.tools.supervise --elastic``);
- training (``python -m fleetx_tpu_torch.tools.train``): GPT at seq 1024
  and 8192, the MoE GPT, ERNIE, ViT and Imagen, with fp16, QAT, the
  recompute policies, checkpoints, the resilience runtime, the SDC
  sentinel and the telemetry; LoRA fine-tuning (``tools.finetune``) and
  the auto-layout entry point (``tools.auto``);
- data: synthetic sets, ``GPTDataset`` and ``BlendedDataset`` on corpora
  written by ``tools.preprocess_data`` (indexed by the native builder in
  ``data/native``), ``tools.multiprocess_tool`` for sharded jobs;
- generation, eval, export and inference (``tasks/gpt/generation.py``,
  ``tools.eval``, ``tools.export``, ``tools.inference``, data-parallel
  over a world of ranks), the Imagen cascade
  (``tasks/imagen/generate.py``).

The hand-written Hopper kernels are in ``csrc/``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` / ``--device cpu``.
Training runs on one device: distributed training is ROADMAP.md's port
queue item 12.
"""
