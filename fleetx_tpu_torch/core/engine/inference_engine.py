"""Inference over an exported artifact (port of
``fleetx_tpu/core/engine/inference_engine.py:29-217``).

``InferenceEngine(model_dir)`` loads what ``utils/export.py`` wrote
(``program.pt2``, ``params.npz``, ``meta.json``) onto one device and
keeps the reference's contract: ``predict(list of numpy arrays) -> list
of numpy arrays``.

- ``target: forward``: ``predict([tokens, position_ids])`` →
  ``[logits]`` (``[b, s, vocab]``; bf16 logits come back as f32, numpy
  has no bf16);
- ``target: generation``: ``predict([tokens, attention_mask, seed])`` →
  ``[ids]``, ``[b * num_return_sequences, max_new_tokens]`` int32: the
  decode loop of ``models/gpt/generation.py`` over the exported prefill
  and decode programs, with the generation config the export recorded.
  ``seed`` is a JAX-style key (``[hi, lo]`` uint32, or one integer):
  sampling draws from a generator seeded with ``hi << 32 | lo``, which is
  ``Global.seed`` for the key ``PRNGKey(Global.seed)``.

Each call records its latency in the process registry
(``observability/metrics.py``): the first call in
``request_compile_latency``, later ones in ``request_latency``
(``latency_summary``); ``requests_total`` counts every call and
``requests_failed_total`` the ones that raised; each call runs under the
span ``inference_predict`` (``observability/trace.py``), as in JAX,
while a tracer, the flight recorder or a profiler window reads it.

**Data-parallel serving** (the reference's ``inference_gpt_345M_dp8``
recipe): ``serving_mesh`` builds the mesh of a ``Distributed`` section
over the process group's ranks (``parallel/mesh.py``). With ``data`` ×
``fsdp`` above 1 each rank runs the exported program on its shard of the
batch, and the rank >= 2 outputs are all-gathered along the batch; the
batch contract and its errors are JAX's: batch-carrying inputs (rank >=
2) carry ``exported_batch * dp`` rows, rank 0/1 inputs (seeds) go to
every shard, rank 0/1 outputs come from this rank's shard. ``mp`` above
1 raises: a ``torch.export`` program cannot be partitioned the way GSPMD
partitions StableHLO, and the tensor-parallel forward comes with
distributed training (ROADMAP.md, port queue item 12).
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.observability.trace import span_if_traced
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.export import load_exported, read_meta
from fleetx_tpu_torch.utils.log import logger


def serving_mesh(dist_cfg: Optional[dict], device=None):
    """The mesh for distributed serving, or None for one device: a
    ``dp_degree`` × ``fsdp`` / ``sharding_degree`` × ``mp_degree`` product
    above 1 joins the process group (``utils/env.init_dist_env``;
    ``device`` feeds its backend rule) and lays the ranks out
    (``build_mesh``, which raises when the degrees do not cover the
    world). Shared by ``tools/serve.py``, ``tools/inference.py`` and
    ``tasks/gpt/inference.py``."""
    dist = dict(dist_cfg or {})
    dp = int(dist.get("dp_degree") or 1)
    fsdp = int(dist.get("fsdp_degree")
               or (dist.get("sharding") or {}).get("sharding_degree") or 1)
    mp = int(dist.get("mp_degree") or 1)
    if dp * fsdp * mp <= 1:
        return None
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.utils.env import init_dist_env

    init_dist_env(device=device)
    if "fsdp_degree" not in dist and fsdp > 1:
        dist["fsdp_degree"] = fsdp
    return build_mesh(dist)


def seed_from_key(seed: Any) -> int:
    """A JAX-style key ``[hi, lo]`` (or one integer) → one 64-bit seed."""
    words = [int(w) & 0xFFFFFFFF for w in np.asarray(seed).reshape(-1)]
    if len(words) == 1:
        return words[0]
    if len(words) != 2:
        raise ValueError(f"seed must be one integer or a [hi, lo] key, got "
                         f"{len(words)} words")
    return (words[0] << 32) | words[1]


class InferenceEngine:
    """Runs an exported model directory (``device``: default ``cuda``, a
    rank's own device on a mesh; the artifact must have been exported for
    that device type), data-parallel over ``mesh``'s ``data`` and ``fsdp``
    axes (module docstring).
    ``gen_cfg`` (generation) may be replaced by one that differs in knobs
    the programs do not depend on (greedy against sampling, top-k, top-p,
    temperature), not in those that set the decode batch (beams, returned
    sequences)."""

    def __init__(self, model_dir: str, mesh=None,
                 device: Union[str, torch.device, None] = None):
        self.mesh = mesh
        self._batch_axes: tuple = ()
        self.dp = 1
        self.mp = 1
        if mesh is not None:
            if not hasattr(mesh, "shape") or not hasattr(mesh, "axis_index"):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            self._batch_axes = tuple(a for a in ("data", "fsdp")
                                     if mesh.shape.get(a, 1) > 1)
            for a in self._batch_axes:
                self.dp *= mesh.shape[a]
            self.mp = mesh.shape.get("tensor", 1)
            if self.mp > 1:
                raise NotImplementedError(
                    f"serving an export over mp {self.mp} needs the "
                    f"tensor-parallel forward, not ported yet (ROADMAP.md, "
                    f"port queue item 12)")
            if mesh.size > 1:
                from fleetx_tpu_torch.utils.env import rank_device

                device = rank_device(device)
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.meta = read_meta(model_dir)
        t0 = time.perf_counter()
        self.programs, self.params = load_exported(model_dir, self.device)
        self.load_s = time.perf_counter() - t0
        self.target = self.meta.get("target", "forward")
        self._warm = False
        self.metrics = get_registry()
        if self.target == "generation":
            from fleetx_tpu_torch.models.gpt import generation as G

            self.gen_cfg = G.GenerationConfig(**self.meta["generation"])
            self.beam = bool(self.meta.get("beam_search"))
            self.decoder = G.exported_decoder(
                self.programs["prefill"], self.programs["decode"],
                self.params)
        logger.info("loaded exported %s model from %s on %s in %.2fs "
                    "(dp=%d, mp=%d)", self.target, model_dir, self.device,
                    self.load_s, self.dp, self.mp)

    def predict(self, inputs: Sequence[Any]) -> list:
        """numpy in → numpy out (see the module docstring)."""
        t0 = time.perf_counter()
        try:
            with span_if_traced("inference_predict"):
                out = self._predict(inputs)
        except BaseException:
            # a failed call counts toward the total, not toward latency
            self.metrics.counter("requests_total").inc()
            self.metrics.counter("requests_failed_total").inc()
            raise
        dt = time.perf_counter() - t0
        name = "request_latency" if self._warm else "request_compile_latency"
        self._warm = True
        self.metrics.histogram(name).record(dt)
        self.metrics.counter("requests_total").inc()
        return out

    def latency_summary(self) -> dict:
        """p50/p95/p99 etc. of warm request latencies (seconds)."""
        return self.metrics.histogram("request_latency").summary()

    def _tensor(self, a: Any) -> torch.Tensor:
        arr = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if arr.dtype.kind in "iu":
            t = t.long()
        return t.to(self.device)

    def _shard(self, arr: np.ndarray, pos: int) -> np.ndarray:
        """This rank's rows of a batch-carrying input (rank >= 2); rank
        0/1 inputs (seeds, scalars) go to every shard. A leading dim that
        does not divide dp raises, as in JAX."""
        if arr.ndim < 2:
            return arr
        if arr.shape[0] % self.dp:
            raise ValueError(
                f"input {pos}: leading dim {arr.shape[0]} not divisible "
                f"by dp={self.dp}; dp serving expects exported_batch * dp "
                f"rows (build the engine without a mesh for single-device "
                f"calls)")
        at = 0
        for a in self._batch_axes:
            at = at * self.mesh.shape[a] + self.mesh.axis_index(a)
        rows = arr.shape[0] // self.dp
        return arr[at * rows:(at + 1) * rows]

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        """A rank >= 2 output's shards concatenated along the batch, in
        the order of the batch axes (``fsdp`` inner)."""
        from fleetx_tpu_torch.parallel.mesh import all_gather

        if out.dim() < 2:
            return out
        for a in reversed(self._batch_axes):
            out = all_gather(out, a, self.mesh, dim=0)
        return out

    @torch.no_grad()
    def _predict(self, inputs: Sequence[Any]) -> list:
        if self.dp > 1:
            inputs = [self._shard(np.asarray(a), i)
                      for i, a in enumerate(inputs)]
        if self.target == "generation":
            from fleetx_tpu_torch.models.gpt import generation as G

            if len(inputs) != 3:
                raise ValueError("generation takes [tokens, attention_mask, "
                                 f"seed], got {len(inputs)} inputs")
            tokens, mask = (self._tensor(a) for a in inputs[:2])
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed_from_key(inputs[2]))
            out = G.generate_rows(None, None, self.gen_cfg, tokens, mask,
                                  self.beam, generator, self.decoder)
            return [self._gather(out).cpu().numpy()]
        outs = self.programs["model"](self.params,
                                      *(self._tensor(a) for a in inputs))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        return [self._gather(o.float() if o.dtype == torch.bfloat16 else o
                             ).cpu().numpy() for o in outs]
