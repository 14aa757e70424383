"""Export entry point (port of the root ``tools/export.py``)::

    python -m fleetx_tpu_torch.tools.export \
        -c fleetx_tpu/configs/nlp/gpt/inference_gpt_345M_single_card.yaml \
        -o Engine.save_load.ckpt_dir=./output [-o Inference.target=forward] \
        [--device cuda|cpu]

Writes the artifact of ``fleetx_tpu_torch/utils/export.py`` to
``Inference.model_dir`` (default ``./exported``), for the device it runs
on. Targets:

- ``forward``: the logits program ``(params, tokens, position_ids) →
  [b, s, vocab]`` at ``[1, max_position_embeddings]`` int64 inputs;
- ``generation`` (the default when the config has a ``Generation``
  section): two programs, the prefill ``(params, tokens, attention_mask)``
  at ``[Inference.batch_size, Inference.prompt_len]`` and the one-token
  decode step at the decode loop's batch (``batch_size`` times
  ``num_beams`` under beam search, else times ``num_return_sequences``),
  with the generation config in ``meta.json``; ``InferenceEngine`` runs
  the decode loop over them.

The parameters come from the newest checkpoint under
``Engine.save_load.ckpt_dir``, verified (a checkpoint that fails its audit
raises); with none configured or present the tool warns and exports
seeded random weights. Prints one JSON line: the target, the directory,
the export seconds and the artifact's bytes. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import torch


def load_config(path: str, overrides: Optional[list] = None):
    """The YAML at ``path`` with dotted overrides, post-processed."""
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(path, overrides)


def programs(cfg: dict, module, device) -> tuple:
    """``(target, fns, example inputs, extra meta)`` for the config's
    ``Inference.target``."""
    from fleetx_tpu_torch.models.gpt import generation as G
    from fleetx_tpu_torch.models.gpt import model as M

    inf = dict(cfg.get("Inference") or {})
    target = inf.get("target") or (
        "generation" if cfg.get("Generation") else "forward")
    mc = module.model_cfg
    meta = {"target": target, "dtype": str(mc.dtype).replace("torch.", "")}
    if target == "forward":
        def forward(params, tokens, position_ids):
            return M.gpt_for_pretraining(params, mc, tokens, position_ids)

        spec = module.input_spec()
        example = tuple(torch.zeros(spec[k][0], dtype=spec[k][1],
                                    device=device)
                        for k in ("tokens", "position_ids"))
        return target, forward, example, meta
    if target != "generation":
        raise ValueError(f"Inference.target {target!r} is not forward or "
                         f"generation")
    if not hasattr(module, "gen_cfg"):
        raise ValueError("the generation target needs Model.module: "
                         "GPTGenerationModule")
    gc = module.gen_cfg
    b = int(inf.get("batch_size", 1))
    prompt_len = int(inf.get("prompt_len", 128))
    rows = b * (gc.num_beams if module.use_beam_search
                else max(int(gc.num_return_sequences), 1))
    total = prompt_len + int(gc.max_new_tokens)
    cache = M.init_cache(mc, rows, total, device=device)
    long = dict(dtype=torch.long, device=device)
    fns = {"prefill": G.prefill_program(mc, int(gc.max_new_tokens)),
           "decode": G.decode_program(mc)}
    example = {
        "prefill": (torch.zeros((b, prompt_len), **long),
                    torch.ones((b, prompt_len), **long)),
        "decode": (torch.zeros((rows,), **long),
                   torch.full((rows,), prompt_len, **long), cache.key,
                   cache.value, cache.mask,
                   torch.full((), prompt_len, **long))}
    meta.update(generation=dataclasses.asdict(gc),
                beam_search=bool(module.use_beam_search), batch_size=b,
                prompt_len=prompt_len, decode_rows=rows)
    return target, fns, example, meta


def export(cfg: dict, device=None) -> dict:
    """Build the module and its parameters and write the artifact; the
    record printed by ``main``."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.export import export_model

    module = build_module(cfg)
    engine = EagerEngine(cfg, module, mode="inference", device=device)
    params = engine.prepare()
    out_dir = str((cfg.get("Inference") or {}).get("model_dir")
                  or "./exported")
    target, fns, example, meta = programs(cfg, module, engine.device)
    t0 = time.perf_counter()
    export_model(fns, example, out_dir, params, meta=meta)
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out_dir, f))
               for f in os.listdir(out_dir))
    return {"target": target, "model_dir": out_dir, "export_s": seconds,
            "artifact_bytes": size, "device": str(engine.device)}


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import parse_args

    args = parse_args("fleetx_tpu_torch export", argv)
    print(json.dumps(export(load_config(args.config, args.override),
                            device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
