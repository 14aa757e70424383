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
Serving over several devices (a dp or mp degree above 1) raises:
``serving_mesh`` names items 4 and 12.
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


def serving_mesh(dist_cfg: Optional[dict]):
    """None for one device; a ``Distributed`` section with a dp, fsdp /
    sharding or mp degree above 1 raises (the JAX engine serves those over
    a mesh)."""
    dist = dict(dist_cfg or {})
    dp = int(dist.get("dp_degree") or 1)
    fsdp = int(dist.get("fsdp_degree")
               or (dist.get("sharding") or {}).get("sharding_degree") or 1)
    mp = int(dist.get("mp_degree") or 1)
    if dp * fsdp * mp > 1:
        raise NotImplementedError(
            f"serving an export over dp {dp} x fsdp {fsdp} x mp {mp} devices "
            f"is not ported yet (ROADMAP.md, port queue items 4 and 12)")
    return None


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
    """Runs an exported model directory on one device (``device``:
    default ``cuda``; the artifact must have been exported for that device
    type). ``mesh`` must be None: multi-device serving is not ported.
    ``gen_cfg`` (generation) may be replaced by one that differs in knobs
    the programs do not depend on (greedy against sampling, top-k, top-p,
    temperature), not in those that set the decode batch (beams, returned
    sequences)."""

    def __init__(self, model_dir: str, mesh=None,
                 device: Union[str, torch.device, None] = None):
        if mesh is not None:
            raise NotImplementedError(
                "InferenceEngine over a mesh is not ported yet (ROADMAP.md, "
                "port queue items 4 and 12)")
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
        logger.info("loaded exported %s model from %s on %s in %.2fs",
                    self.target, model_dir, self.device, self.load_s)

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

    @torch.no_grad()
    def _predict(self, inputs: Sequence[Any]) -> list:
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
            return [out.cpu().numpy()]
        outs = self.programs["model"](self.params,
                                      *(self._tensor(a) for a in inputs))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
                for o in outs]
