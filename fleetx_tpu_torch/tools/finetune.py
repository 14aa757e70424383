"""LoRA fine-tuning entry point of the port (port of ``tools/finetune.py``)::

    python -m fleetx_tpu_torch.tools.finetune \
        -c fleetx_tpu/configs/nlp/gpt/finetune_gpt_345M_lora.yaml \
        -o FineTune.base_ckpt=./output/pretrain [-o Engine.max_steps=200]
        [--device cuda|cpu]

The config is a training recipe whose ``Model.module`` is
``LoRAGPTModule`` plus a ``FineTune:`` section naming the pretrain
checkpoint (``base_ckpt``, required) and where the adapter artifact goes
(``adapter_dir``, default ``<Engine.save_load.output_dir>/adapter``).
The run restores the base (verified against its digests), fits only the
adapter leaves under ``lora_optimizer``, audits the base bitwise frozen
and publishes the adapter-only artifact that ``tools.serve`` merges
(``Serving.adapter_dir``). ``Engine.save_load.save_steps`` saves the
fine-tune state (base + adapters, the adapters' AdamW moments) through
the engine, and ``ckpt_dir`` resumes it; the resumed run grafts the same
base again.

It runs on ``cuda`` unless ``--device cpu`` is given, and prints one
JSON line: the logged losses and grad norms, step times, tokens/s, peak
memory, ``trainable_params_frac``, the artifact's path and bytes, each
adapter leaf's largest change over the run, and the launches of the
training kernels during it (the norm forward's also on its ``"rows"``
route).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
from typing import Optional

import torch


def _launch_counters() -> dict:
    """Name → ``(wrapper, attribute)`` of the training kernels' counts."""
    from fleetx_tpu_torch.ops import flash_attention as FA
    from fleetx_tpu_torch.ops import fused_norm as FN

    out = {}
    for name, fn in (("flash_attention_fwd", FA.fwd_call),
                     ("flash_attention_bwd_fused", FA.bwd_call),
                     ("flash_attention_bwd_dq", FA.bwd_dq_call),
                     ("flash_attention_bwd_dkv", FA.bwd_dkv_call)):
        out[name] = (fn, "launches")
        out[name + "_tc"] = (fn, "tc_launches")
    out["fused_norm_fwd"] = (FN.fwd_call, "launches")
    out["fused_norm_fwd_rows"] = (FN.fwd_call, "rows_launches")
    out["fused_norm_bwd"] = (FN.bwd_call, "launches")
    return out


def run(cfg: dict, device=None) -> dict:
    """Build the fine-tune trainer and run the recipe; returns the
    summary the CLI prints."""
    from fleetx_tpu_torch.core import checkpoint as ckpt_lib
    from fleetx_tpu_torch.finetune import lora
    from fleetx_tpu_torch.finetune.checkpoint import adapter_bytes
    from fleetx_tpu_torch.finetune.module import LoRAGPTModule
    from fleetx_tpu_torch.finetune.recipe import finetune
    from fleetx_tpu_torch.tools.train import build_trainer

    engine, train_dl, valid_dl = build_trainer(
        cfg, device, wrap_optimizer=lora.lora_optimizer)
    module = engine.module
    if not isinstance(module, LoRAGPTModule):
        raise ValueError("tools.finetune requires Model.module: "
                         "LoRAGPTModule")
    if not module.base_ckpt:
        raise ValueError("FineTune.base_ckpt must name the pretrain "
                         "checkpoint directory")
    adapter_dir = module.adapter_dir or \
        os.path.join(engine.output_dir, "adapter")
    counters = _launch_counters()
    start: dict = {}

    def on_prepared(eng) -> None:
        """Keep the adapters' starting values; zero every count."""
        _, adapters = lora.split_adapters(eng.params)
        start.update({k: v.detach().clone() for k, v in adapters.items()})
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        if eng.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(eng.device)

    losses, path = finetune(engine, train_dl, valid_dl,
                            base_dir=module.base_ckpt,
                            adapter_dir=adapter_dir,
                            on_prepared=on_prepared)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    _, adapters = lora.split_adapters(engine.params)
    moved = {k: float((v.detach().float() - start[k].float()).abs().max())
             for k, v in adapters.items()}
    glb = dict(cfg.get("Global") or {})
    tokens = int(glb.get("global_batch_size", 8)) * \
        int(glb.get("max_seq_len", 1024))
    steps_ms = [h["train_cost"] * 1e3 for h in engine.history]
    median_ms = statistics.median(steps_ms[1:] or steps_ms) \
        if steps_ms else None
    total = sum(int(v.numel())
                for v in ckpt_lib.flatten(engine.params).values())
    out = dict(steps=engine.step, losses=losses,
               grad_norms=[h["grad_norm"] for h in engine.history],
               step_ms=steps_ms, step_ms_median=median_ms,
               tokens_per_s=tokens / median_ms * 1e3 if median_ms else None,
               trainable_params_frac=lora.trainable_params_frac(
                   engine.params), total_params=total,
               trainable_params=sum(int(v.numel())
                                    for v in adapters.values()),
               adapter_path=path, adapter_bytes=adapter_bytes(path),
               adapters_moved=moved, launches=launches,
               device=str(engine.device))
    if engine.device.type == "cuda":
        out["peak_memory_gb"] = \
            torch.cuda.max_memory_allocated(engine.device) / 2 ** 30
    return out


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.tools.train import load_config
    from fleetx_tpu_torch.utils.config import parse_args

    args = parse_args("fleetx_tpu_torch lora finetune", argv)
    out = run(load_config(args.config, args.override), device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
