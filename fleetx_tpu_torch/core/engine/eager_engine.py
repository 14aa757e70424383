"""The training engine (port of ``fleetx_tpu/core/engine/eager_engine.py``:
``__init__`` :117-357, ``train_step`` :554-648, ``fit`` :836-1496,
``evaluate`` :1614).

``EagerEngine`` reads the ``Engine`` section and drives one device:

- ``prepare`` makes the seeded parameters (``Global.seed``) unless the
  caller set ``engine.params`` (converted JAX weights in the tests), and
  the optimizer state;
- ``train_step`` takes the grads of ``GPTModule.training_loss``, sums
  microbatch grads in an f32 carry when ``accumulate_steps > 1``, records
  the ``lr`` and ``grad_norm`` metrics and applies the AdamW update in
  place. Every microbatch of a step shares the step's dropout randomness,
  as the JAX step does;
- ``fit`` loops until ``max_steps`` (re-iterating the loader), logs
  through ``training_step_end`` every ``logging_freq`` steps and
  evaluates every ``eval_freq`` steps when an eval loader exists; it
  returns the logged losses. ``history`` keeps each logged step's loss,
  grad norm, lr and wall time.

Input batches move to the card through pinned memory with non-blocking
copies. What this slice does not cover raises ``NotImplementedError``
naming its ROADMAP item: checkpoint save/resume (``save_steps``,
``ckpt_dir``), fp16 with the loss scaler and ``Resilience.enable`` (the
non-finite skip runs only under those two), ``Profiler.enable``, the
epoch run mode, and any ``Distributed`` degree above 1.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.utils.config import check_single_device
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger


def _int(section: dict, key: str, default: int) -> int:
    v = section.get(key, default)
    return default if v is None else int(v)


def check_engine_config(cfg: dict) -> None:
    """Raise on an Engine/Distributed/Resilience/Profiler value the
    training slice does not cover."""
    eng = dict(cfg.get("Engine") or {})
    save_load = dict(eng.get("save_load") or {})
    if save_load.get("save_steps") or save_load.get("ckpt_dir"):
        raise NotImplementedError(
            "Engine.save_load.save_steps / ckpt_dir need training checkpoint "
            "save/resume, not ported yet (ROADMAP.md, port queue item 3)")
    mp = dict(eng.get("mix_precision") or {})
    model_dtype = str((cfg.get("Model") or {}).get("dtype") or "")
    if mp.get("use_pure_fp16") or model_dtype == "float16":
        raise NotImplementedError(
            "fp16 with the dynamic loss scaler is not ported yet "
            "(ROADMAP.md, port queue item 11)")
    if (cfg.get("Resilience") or {}).get("enable"):
        raise NotImplementedError(
            "Resilience.enable (guard, rollback, non-finite skip) is not "
            "ported yet (ROADMAP.md, port queue item 11)")
    if (cfg.get("Profiler") or {}).get("enable"):
        raise NotImplementedError(
            "the Profiler window is not ported yet (ROADMAP.md, port queue "
            "item 8)")
    if str(eng.get("run_mode") or "step") != "step":
        raise NotImplementedError(
            "Engine.run_mode other than 'step' belongs to the vision family "
            "(ROADMAP.md, port queue item 7)")
    check_single_device(dict(cfg.get("Distributed") or {}))


class EagerEngine:
    """Single-device trainer with the reference's loop semantics."""

    def __init__(self, cfg: dict, module, optimizer=None, lr_schedule=None,
                 device=None):
        check_engine_config(cfg or {})
        self.cfg = cfg or {}
        self.module = module
        self.device = resolve_device(device)
        eng = dict(self.cfg.get("Engine") or {})
        self.max_steps = _int(eng, "max_steps", 500000)
        self.logging_freq = max(_int(eng, "logging_freq", 1), 1)
        self.eval_freq = _int(eng, "eval_freq", 0)
        self.eval_iters = _int(eng, "eval_iters", 10)
        self.accumulate_steps = max(_int(eng, "accumulate_steps", 1), 1)
        self.seed = int((self.cfg.get("Global") or {}).get("seed", 1234))
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.params: Optional[dict] = None
        self.opt_state: Optional[dict] = None
        self.step = 0
        self.history: list = []

    # ------------------------------------------------------------ state
    def prepare(self) -> dict:
        """Seeded parameters (unless already set) and optimizer state."""
        if self.params is None:
            t0 = time.time()
            self.params = self.module.init_params(self.seed, self.device)
            n = sum(p.numel() for _, p in tree_leaves_with_path(self.params))
            logger.info("initialized parameters in %.1fs (%d params)",
                        time.time() - t0, n)
        self._leaves = [p for _, p in tree_leaves_with_path(self.params)]
        for p in self._leaves:
            if p.device != self.device:
                raise ValueError(f"parameter on {p.device}, engine on "
                                 f"{self.device}")
            p.requires_grad_(True)
        if self.optimizer is not None and self.opt_state is None:
            self.opt_state = self.optimizer.init(self.params)
        return self.params

    def to_device(self, batch: dict) -> dict:
        """Host numpy batch → tensors on the engine's device (pinned,
        non-blocking copies to a card)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------- step
    def _grads(self, batch: dict):
        loss, metrics = self.module.training_loss(self.params, batch,
                                                  self.seed, self.step)
        grads = torch.autograd.grad(loss, self._leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a device batch; returns device metrics."""
        accum = self.accumulate_steps
        if accum > 1:
            lead = batch["tokens"].shape[0]
            if lead % accum:
                raise ValueError(
                    f"local batch {lead} is not divisible by "
                    f"accumulate_steps {accum} — fix Global.local/"
                    f"micro_batch_size or Engine.accumulate_steps")
            carry_dtype = getattr(self.module.model_cfg, "grad_accum_dtype",
                                  None)
            grads, metrics = None, None
            for i in range(accum):
                micro = {k: v.chunk(accum)[i] for k, v in batch.items()}
                g, m = self._grads(micro)
                if grads is None:
                    grads = [x.to(carry_dtype or x.dtype) for x in g]
                    metrics = m
                else:
                    grads = [a + x.to(a.dtype) for a, x in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [(g / accum).to(p.dtype)
                     for g, p in zip(grads, self._leaves)]
            metrics = {k: v / accum for k, v in metrics.items()}
        else:
            grads, metrics = self._grads(batch)
        if self.lr_schedule is not None:
            metrics["lr"] = float(self.lr_schedule(self.step))
        if self.optimizer is not None:
            metrics["grad_norm"] = self.optimizer.update(
                self._leaves, list(grads), self.opt_state)
        self.step += 1
        return metrics

    # -------------------------------------------------------------- fit
    def fit(self, train_data_loader: Iterable,
            valid_data_loader=None) -> list:
        """Train until ``max_steps``, re-iterating the loader; returns the
        logged losses."""
        self.prepare()
        losses: list = []
        if self.step >= self.max_steps:
            return losses
        t_last = time.time()
        window = 0
        epoch = 0
        it = iter(train_data_loader)
        while self.step < self.max_steps:
            batch = next(it, None)
            if batch is None:  # re-iterate epochs over the same loader
                epoch += 1
                it = iter(train_data_loader)
                batch = next(it, None)
                if batch is None:
                    break
            batch = self.to_device(self.module.pretreating_batch(batch))
            metrics = self.train_step(batch)
            window += 1
            if window % self.logging_freq == 0:
                loss = float(metrics["loss"])  # one sync per window
                now = time.time()
                cost = (now - t_last) / self.logging_freq
                t_last = now
                losses.append(loss)
                grad_norm = metrics.get("grad_norm")
                record = {
                    "global_step": self.step, "epoch": epoch,
                    "batch": window, "loss": loss, "train_cost": cost,
                    "global_batch_size": int(batch["tokens"].shape[0]),
                    "lr": metrics.get("lr", 0.0), "device": self.device,
                    "grad_norm": None if grad_norm is None
                    else float(grad_norm)}
                self.module.training_step_end(record)
                self.history.append(record)
            if self.eval_freq and valid_data_loader is not None and \
                    self.step % self.eval_freq == 0:
                self.evaluate(valid_data_loader, global_step=self.step)
        return losses

    @torch.no_grad()
    def evaluate(self, valid_data_loader: Iterable,
                 global_step: int = 0) -> float:
        """Mean validation loss over at most ``eval_iters`` batches."""
        self.prepare()
        total, count = 0.0, 0
        t0 = time.time()
        for i, batch in enumerate(valid_data_loader):
            if i >= self.eval_iters:
                break
            batch = self.to_device(self.module.pretreating_batch(batch))
            loss, _ = self.module.validation_loss(self.params, batch)
            total += float(loss)
            count += 1
        if count:
            self.module.validation_step_end({
                "global_step": global_step, "batch": count,
                "loss": total / count,
                "eval_cost": (time.time() - t0) / count})
        return total / max(count, 1)
