"""Inference entry point (port of the root ``tools/inference.py``)::

    python -m fleetx_tpu_torch.tools.export -c <cfg>     # writes model_dir
    python -m fleetx_tpu_torch.tools.inference -c <cfg> [--device cuda|cpu]

Loads ``Inference.model_dir`` into an ``InferenceEngine`` and runs one
demo batch, as the reference's smoke loop does: zeros of ``[Inference.batch_size,
Inference.prompt_len]`` with an all-ones mask and seed ``[0, 0]`` for a
generation export, or zeros with ``arange`` positions for a forward one.
Prints one JSON line per output (shape, dtype; a generation export's
first row of ids too) and one with the call's seconds. Runs on ``cuda``
unless ``--device cpu`` is given; the artifact must have been exported
for the same device type.

A ``Distributed`` section with ``dp_degree`` (or fsdp / sharding) above 1
serves data-parallel over the world of ``tools.supervise --num-procs N``
(``inference_gpt_345M_dp8.yaml``): the config's degrees are checked
against the world, the demo batch carries ``batch_size * dp`` rows, each
rank runs its shard, and every rank prints the gathered outputs with its
rank.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np


def run(cfg: dict, device=None) -> list:
    """The demo batch through the exported model; the printed records."""
    from fleetx_tpu_torch.core.engine.inference_engine import (
        InferenceEngine, serving_mesh)

    inf = dict(cfg.get("Inference") or {})
    glb = dict(cfg.get("Global") or {})
    engine = InferenceEngine(str(inf.get("model_dir") or "./exported"),
                             mesh=serving_mesh(cfg.get("Distributed")),
                             device=device)
    target = engine.target
    seq = int(inf.get("prompt_len", glb.get("max_seq_len", 128)))
    b = int(inf.get("batch_size", 1)) * engine.dp
    tokens = np.zeros((b, seq), np.int64)
    if target == "generation":
        inputs = [tokens, np.ones((b, seq), np.int64),
                  np.zeros((2,), np.uint32)]
    else:
        inputs = [tokens, np.broadcast_to(np.arange(seq, dtype=np.int64),
                                          (b, seq)).copy()]
    t0 = time.perf_counter()
    outs = engine.predict(inputs)
    seconds = time.perf_counter() - t0
    records = []
    for i, o in enumerate(outs):
        rec = {"output": i, "shape": list(o.shape), "dtype": str(o.dtype)}
        if target == "generation":
            rec["first_row"] = [int(t) for t in o[0]]
        records.append(rec)
    records.append({"target": target, "seconds": seconds,
                    "load_s": engine.load_s, "dp": engine.dp,
                    "rank": engine.mesh.rank if engine.mesh is not None
                    else 0})
    return records


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import get_config, parse_args
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_world_size,
                                            init_dist_env)

    args = parse_args("fleetx_tpu_torch inference", argv)
    init_dist_env(device=args.device)
    try:
        records = run(get_config(args.config, args.override,
                                 num_devices=get_world_size()),
                      device=args.device)
    finally:
        close_dist_env()
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
