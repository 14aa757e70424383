"""The training engine (port of ``fleetx_tpu/core/engine/eager_engine.py``:
``ScalerState`` :49, ``__init__`` :117-357, ``train_step`` :505-648,
the SDC sentinel :716-835, ``fit`` :836-1496, ``evaluate`` :1614, ``predict`` :1639, ``inference``
:1662, ``_auto_resume_rewind`` :1706).

``EagerEngine`` reads the ``Engine`` section and drives one device:

- ``prepare`` makes the seeded parameters (``Global.seed``) unless the
  caller set ``engine.params`` (converted JAX weights in the tests), and
  the optimizer state;
- ``train_step`` takes the grads of the module's ``training_loss``, sums
  microbatch grads in an f32 carry when ``accumulate_steps > 1``, records
  the ``lr`` and ``grad_norm`` metrics and applies the AdamW update in
  place. Every microbatch of a step shares the step's dropout randomness,
  as the JAX step does;
- ``fit`` loops until ``max_steps`` (re-iterating the loader), logs
  through ``training_step_end`` every ``logging_freq`` steps and
  evaluates every ``eval_freq`` steps when an eval loader exists; it
  returns the logged losses. ``history`` keeps each logged step's loss,
  grad norm, lr and wall time.

Checkpoints (``save`` :1674, ``load`` :1746, the resume at engine build
:447 and the sampler rewind :846-884): with ``Engine.save_load.save_steps``
set, ``fit`` saves every ``save_steps`` steps under ``output_dir``
(``core/checkpoint.py``: params, the AdamW state, the step, and meta
``consumed_samples`` / ``epoch`` / ``seed``), then prunes to
``keep_last`` / ``keep_every``. With ``ckpt_dir`` set, ``prepare``
restores the newest step there that verifies, falling back past a
corrupt step to the newest older one, and ``fit`` points the loader's
``consumed_samples`` sampler at the restored position, so the next batch
is the one the uninterrupted run would take. The step's dropout
randomness is a function of ``Global.seed`` and the step, so a resumed
run replays it.

``mode`` is ``"train"`` (the default), ``"eval"`` or ``"inference"``. An
eval engine needs no optimizer: ``prepare`` takes the parameters from the
newest checkpoint under ``ckpt_dir`` through ``core/checkpoint.load_params``
(params only, verified; a checkpoint that fails its audit raises), or,
with no checkpoint there, warns and makes seeded ones; nothing requires
grad. ``predict`` runs ``module.predict_step`` over a loader (host numpy
out); ``inference`` hands numpy inputs to the ``InferenceEngine`` of
``Inference.model_dir``.

The fp16 dynamic loss scaler (``Engine.mix_precision.use_pure_fp16`` with
``Model.dtype: float16``, ``utils/config.loss_scaler``): the loss is
scaled by ``loss_scale`` (f32, init ``scale_loss``) before the backward,
and AdamW unscales the grads by ``1 / loss_scale`` in its leaf loop; the
scale doubles after ``GROWTH_INTERVAL`` finite steps in a row and halves
on every non-finite one. ``scaler`` holds the two leaves of the JAX
``ScalerState`` as host numpy scalars (``loss_scale`` f32,
``growth_tracker`` i32); checkpoints keep them as
``scaler/loss_scale`` and ``scaler/growth_tracker``.

The non-finite skip runs when the scaler is on or
``Resilience.guard.skip_nonfinite_update`` is (``check_finite``), in any
dtype: ``finite = isfinite(grad_norm) & isfinite(loss)``, and a
non-finite step leaves the params and the AdamW state as they were and
advances neither ``step`` (so neither the LR schedule nor the dropout
randomness) nor ``AdamW``'s count. The JAX step selects the old values
on the device; here ``step``, the LR and the dropout seeds are host
values the next step is built from, so the host reads ``finite`` once a
step (one sync) and skips the update itself, which gives the same bits.
With the check off the step has no sync and is what it was before.

The resilience runtime (``Resilience``, ``resilience/``; inert unless
``Resilience.enable``): ``auto_resume`` restores the newest checkpoint
under ``ckpt_dir`` or ``output_dir``; the fault plan sees every host
batch and SIGTERMs the process at ``sigterm_at``; a latched SIGTERM /
SIGINT saves the step, counts ``preemption_exits`` and raises
``SystemExit(preemption.exit_code)`` at the next step boundary; the step
watchdog is beaten after every step and suspended around saves,
restores and evals; the guard reads each logging window and its
``rollback`` restores the newest completed step under ``output_dir``
(rewinding the data position, counting ``rollbacks_total``, resetting the
save and eval markers) and its ``abort`` raises ``TrainingAborted``.
With a re-iterable loader, ``fit`` runs until ``max_steps`` optimizer
steps are done, skipped batches not counted.

The state-integrity runtime (``Resilience.integrity``):
``verify_checkpoints`` sets the checkpoint layer's verify mode
(``core/checkpoint.set_verify_mode``). The SDC sentinel
(``sentinel_every`` N > 0, with ``enable``) replays every N-th step and
compares its ``loss`` and ``grad_norm`` with the step's bit for bit
(the kernels and ops of a step are deterministic, so a difference is a
hardware fault): the JAX engine replays its step on the state it kept
through a non-donating twin; the port updates its state in place, so on
a sentinel step it keeps a clone of the parameters, the step counter and
the loss scale from before the step, and the replay runs the forward and
backward on them and the same ``grad_norm`` function, and stops before
the optimizer (nothing it compares comes after). The replay moves no
counter, scaler, guard window, LR, record or data position; the
dropout generators are made anew from ``(seed, step)`` by each call, so
there is no generator state to keep. A mismatch counts
``sdc_replay_mismatches``, is noted in the flight ring, and then logs
(``log``), writes ``<output_dir>/sdc_quarantine.json`` and goes on
(``quarantine``, ``sdc_quarantines``) or raises ``TrainingAborted``
(``abort``). The fault plan's ``bitflip_param_at`` flips bit 0 of the
first element of the first float parameter in JAX's leaf order after
that step's check (``_apply_bitflip``); the fingerprint census that
would catch it needs replicas on other ranks (item 12), as JAX's runs
only on gangs.

``Engine.save_load.async_save``: ``save`` returns once the state is
snapshotted and the writer thread writes it (``core/checkpoint.py``);
``fit`` completes the outstanding save at its end (before retention) and
on the preemption exit, ``load`` and a rollback before they read, each
under the watchdog's ``quiet``. ``FLEETX_FAULT_STEP=K`` ends a fresh run
with ``os._exit(17)`` after step K's save (the supervisor's restart
drill; a resumed run sails past it).

``Distributed.sharding.sharding_offload`` (JAX ``:252-279``): the JAX
engine warns when the step fits the device without the offload, and
turns the offload off, with a warning, on any backend but a TPU. This
port runs on another backend, so it does both and never offloads (JAX's
third warning, the fp16 scaler's, follows only where the offload
survives the backend's).

Input batches move to the card through pinned memory with non-blocking
copies (``to_device``). With ``Engine.prefetch_to_device`` > 0 (every GPT
recipe sets 2) ``data/prefetch.DevicePrefetcher`` makes those copies that
many batches ahead on its own stream, so the copy of batch N+1 overlaps
step N; the batches and the losses are the same bit for bit.

Telemetry (JAX ``eager_engine.py:297-311``, ``_emit_train_record``
:1560, ``_on_profiler_stop`` :1520; no-op unless ``Observability.enable``
/ ``Profiler.enable``): the spans ``data_fetch``, ``shard_batch`` (no
prefetcher) or ``shard_batch_async`` (its producer), ``train_step``,
``optimizer_update``, ``eval`` and ``checkpoint_save``; one record a
logging window to the sinks (``metrics.jsonl`` ...) with tokens/s, MFU,
the stall fraction and the device-memory sample (``MemoryMonitor``: after
the first step, every window, the profiler window's close, eval and
save); the flight ring dumped on a crash, a stall and a preemption. The
profiler window (``observability/trace.ProfilerWindow``) opens at
``Profiler.scheduler[0]`` and closes at ``[1]``; inside it every step is
marked ``ProfilerStep#<step>`` and its forward and backward ``fwd_scan``
and ``bwd_scan`` (``record_function``), and the closed window's trace is
decomposed (``observability/perf.py``) into ``perf.jsonl``. A span
measures the host's launches, not the card's time: the record's
``step_time`` is the logging window's wall, which ends in the loss sync.

A gang (``mesh``; built over the process group when it has more than one
rank): every rank is a process of one ``torch.distributed`` group laid
out on ``parallel/mesh.Mesh`` over ``(pipe, data, fsdp, seq, tensor)``,
and every collective is written by hand (``parallel/sharding.py``):

- ``prepare`` builds the full tree from the seed on every rank, as one
  rank does (or takes the full tree the caller set, or the checkpoint's),
  and keeps the rank's blocks (``sharding.plan_leaves``: the rules'
  tensor-parallel specs, ZeRO stage 3's ``embed`` dims over ``fsdp``,
  the gradient specs under ``overlap_update``); the module runs its
  forward on the mesh (``module.attach_shard``);
- each rank takes its rows of every global batch (``sharding.batch_rows``;
  each microbatch of the global batch split over ``(data, fsdp)``, as
  JAX's reshape places it), so the batches are one rank's bit for bit;
- the grad sync after the backward (``_sync_grads``): a psum over
  ``tensor`` of the replicated leaves under sequence parallelism (their
  grads are partial sums over the sequence blocks), then an all-reduce
  over ``(data, fsdp)``, or at stage 2 and above, for a leaf whose
  optimizer state is split over ``fsdp``, a reduce-scatter over ``fsdp``
  and an all-reduce over ``data``; a leaf the forward gathered over
  ``fsdp`` arrives reduce-scattered already;
- the update (``_sharded_update``) runs on each leaf's optimizer-state
  block (``zero_sharding`` at stages 1 and 2), with the global grad norm
  (each leaf's sum of squares psum'd over the axes it is split on), and
  the parameter is all-gathered back over ``fsdp`` where it is kept
  whole; stage 3 and ``overlap_update`` keep it sharded;
- the fp16 scaler's and the guard's finite flag is a pmax over the mesh;
- ``save`` gathers every leaf, rank 0 writes the files a one-rank run
  writes, and a barrier follows; ``load`` reads the full leaves on every
  rank and cuts them (``_apply_state``), so a checkpoint moves between
  layouts; ``evaluate`` and ``predict`` run on the mesh (``predict``
  returns the whole batch).

What this slice does not cover raises ``NotImplementedError`` naming its
ROADMAP item: per-rank checkpoint directories (item 12), the gang
watchdog (item 12), ``Observability.gang`` (item 12), and on a gang the
resilience runtime and asynchronous saves (item 12's gang resilience);
the config loader refuses the layouts ``utils/config.check_covered``
names.

The engine is family-neutral: the batch size is the leading dim of the
batch's first leaf in key order (``leading_dim``), a loaded tree is
checked by the module's own ``check_params``, and the log line is the
module's. ``Engine.run_mode: epoch`` (the vision recipes) bounds ``fit``
by its ``epoch_num`` (``tools/train.py`` passes
``Engine.num_train_epochs``) besides ``max_steps``: each pass over the
loader is an epoch, the checkpoint meta's ``epoch`` resumes the count,
and a run already at ``epoch_num`` returns at once.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import threading
import time
import weakref
from typing import Iterable, Optional

import numpy as np
import torch

from fleetx_tpu_torch.convert import jax_leaves
from fleetx_tpu_torch.core import checkpoint as ckpt_lib
from fleetx_tpu_torch.core.engine.basic_engine import BasicEngine
from fleetx_tpu_torch.data.prefetch import DevicePrefetcher
from fleetx_tpu_torch.observability import MemoryMonitor, Observability, flight
from fleetx_tpu_torch.observability import memory as memory_mod
from fleetx_tpu_torch.observability.trace import ProfilerWindow
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.parallel import mesh as PM
from fleetx_tpu_torch.parallel import sharding as SH
from fleetx_tpu_torch.parallel.rules import MESH_AXES, SpecLayout, shard_leaf
from fleetx_tpu_torch.resilience import Resilience, TrainingAborted
from fleetx_tpu_torch.resilience import coordination
from fleetx_tpu_torch.resilience.integrity import atomic_write
from fleetx_tpu_torch.utils.config import check_covered, loss_scaler
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

#: finite steps in a row after which the loss scale doubles (the
#: reference GradScaler's ``incr_every_n_steps``)
GROWTH_INTERVAL = 1000


def _int(section: dict, key: str, default: int) -> int:
    v = section.get(key, default)
    return default if v is None else int(v)


def check_engine_config(cfg: dict) -> None:
    """Raise on an Engine/Distributed value the training slice does not
    cover (the ``Resilience`` block's raise in ``resilience.Resilience``,
    ``Observability.gang``'s in ``observability.Observability``)."""
    eng = dict(cfg.get("Engine") or {})
    save_load = dict(eng.get("save_load") or {})
    if save_load.get("per_rank_dirs"):
        raise NotImplementedError(
            "Engine.save_load.per_rank_dirs needs a multi-rank gang, not "
            "ported yet (ROADMAP.md, port queue item 12)")
    check_covered(cfg)


def _gang_mesh(cfg: dict):
    """The mesh of the process group's ranks, or None for one rank."""
    from fleetx_tpu_torch.utils.env import get_world_size

    if get_world_size() <= 1:
        return None
    return PM.build_mesh(dict(cfg.get("Distributed") or {}))


def _refuse_on_gang(cfg: dict) -> None:
    """What a gang does not run yet: item 12's gang resilience part."""
    if (cfg.get("Resilience") or {}).get("enable"):
        raise NotImplementedError(
            "Resilience.enable on a gang needs the gang resilience runtime "
            "(coordinator, gang watchdog, two-phase commit), not ported yet "
            "(ROADMAP.md, port queue item 12)")
    save_load = dict((cfg.get("Engine") or {}).get("save_load") or {})
    if save_load.get("async_save"):
        raise NotImplementedError(
            "Engine.save_load.async_save on a gang needs the gang's "
            "two-phase commit, not ported yet (ROADMAP.md, port queue item "
            "12)")


def import_torch_dynamo() -> None:
    """Import ``torch._dynamo``, on a thread of its own, if nothing has.

    Torch imports it lazily on the first call of a function it keeps from
    dynamo (``torch._compile._disable_dynamo``: a custom op's dispatch,
    ``torch.utils.checkpoint``). That import leaves a reference cycle
    (``torch.fx.wrap`` keeps its own frame in a local) whose ``f_back``
    chain reaches the caller's frames: run inside a training step, it kept
    the engine, its parameters and its optimizer state alive after its
    last name went, until the cyclic collector ran. A thread's frames end
    at its own bootstrap, so there the cycle keeps nothing of the
    caller's.
    """
    if "torch._dynamo" in sys.modules:
        return
    t = threading.Thread(target=importlib.import_module,
                         args=("torch._dynamo",), name="import-torch-dynamo")
    t.start()
    t.join()


#: ``EagerEngine`` modes
MODES = ("train", "eval", "inference")


class EagerEngine(BasicEngine):
    """Single-device trainer with the reference's loop semantics."""

    def __init__(self, cfg: dict, module, optimizer=None, lr_schedule=None,
                 device=None, mode: str = "train", mesh=None):
        check_engine_config(cfg or {})
        if mode not in MODES:
            raise ValueError(f"engine mode {mode!r} is not one of {MODES}")
        self.mode = mode
        import_torch_dynamo()
        self.cfg = cfg or {}
        self.module = module
        # the gang's mesh; None for one rank (a mesh of one is one rank)
        self.mesh = mesh if mesh is not None else _gang_mesh(self.cfg)
        if self.mesh is not None and self.mesh.size == 1:
            self.mesh = None
        if self.mesh is not None:
            from fleetx_tpu_torch.utils.env import rank_device

            _refuse_on_gang(self.cfg)
            device = rank_device(device)
        self.device = resolve_device(device)
        # the rank's placement of every leaf (``prepare``), in leaf order
        self._plan: Optional[dict] = None
        eng = dict(self.cfg.get("Engine") or {})
        self.max_steps = _int(eng, "max_steps", 500000)
        self.logging_freq = max(_int(eng, "logging_freq", 1), 1)
        self.eval_freq = _int(eng, "eval_freq", 0)
        self.eval_iters = _int(eng, "eval_iters", 10)
        self.accumulate_steps = max(_int(eng, "accumulate_steps", 1), 1)
        # "step": loop the loader until max_steps; "epoch": stop after
        # fit's epoch_num passes too
        self.run_mode = str(eng.get("run_mode") or "step")
        self.seed = int((self.cfg.get("Global") or {}).get("seed", 1234))
        save_load = dict(eng.get("save_load") or {})
        self.save_steps = _int(save_load, "save_steps", 0)
        self.output_dir = save_load.get("output_dir") or "./output"
        self.ckpt_dir = save_load.get("ckpt_dir")
        # retention: the newest keep_last completed steps (+ every
        # keep_every-th); 0 keeps everything
        self.keep_last = _int(save_load, "keep_last", 0)
        self.keep_every = _int(save_load, "keep_every", 0)
        # the save returns once the state is snapshotted
        self.async_save = bool(save_load.get("async_save"))
        # depth of the device prefetch queue; 0: fetch, copy and step in
        # series
        self.prefetch_to_device = _int(eng, "prefetch_to_device", 0)
        # the profiler window, re-armed by every fit; its closed window is
        # decomposed into the perf stream
        self.profiler = ProfilerWindow(self.cfg.get("Profiler"))
        # telemetry: registry, spans, sinks; no-op unless enabled
        self.obs = Observability(self.cfg.get("Observability"),
                                 default_output_dir=self.output_dir)
        self._engine_kind = type(self).__name__
        # through a weak reference: the window is the engine's own, and a
        # bound method there would tie the engine (its parameters and
        # optimizer state on the card) into a reference cycle
        engine = weakref.ref(self)
        self.profiler.on_stop = lambda d: engine()._on_profiler_stop(d)
        self.mem: Optional[MemoryMonitor] = None  # built in prepare
        self._perf_flops_per_step: Optional[float] = None
        self._perf_report: Optional[dict] = None
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.params: Optional[dict] = None
        self.opt_state: Optional[dict] = None
        self.step = 0
        self.history: list = []
        self.consumed_samples = 0
        self.epoch = 0
        # None: no restore tried yet; True once a checkpoint was restored
        self._restored: Optional[bool] = None
        self.last_saved_step: Optional[int] = None  # step of the last save
        # the fault-tolerant runtime: inert unless Resilience.enable
        self.resilience = Resilience(self.cfg.get("Resilience"))
        # every recovery decision goes through the coordinator (world 1)
        self.coord = coordination.get_coordinator()
        # manifests, read-backs and verified restores (default on,
        # whatever Resilience.enable says)
        ckpt_lib.set_verify_mode(self.resilience.integrity_verify)
        dist = dict(self.cfg.get("Distributed") or {})
        self.sharding_offload = bool(
            (dist.get("sharding") or {}).get("sharding_offload"))
        if self.sharding_offload:
            self._refuse_offload(dist)
        # the restart drill's crash point (tools/supervise.py)
        self._fault_step = int(os.environ.get("FLEETX_FAULT_STEP") or 0)
        init_scale = loss_scaler(self.cfg)
        self.scaler: Optional[dict] = None
        if init_scale is not None:
            self.scaler = {"loss_scale": np.float32(init_scale),
                           "growth_tracker": np.int32(0)}
        # the in-step non-finite check: the scaler's, or the guard's skip
        # extended to every dtype
        self.check_finite = self.scaler is not None or \
            self.resilience.guard_skip

    def _refuse_offload(self, dist: dict) -> None:
        """JAX's ``sharding_offload`` warnings, in its order and words:
        the step fits without the offload (the planner's estimate against
        the device's memory), then the backend is not a TPU, which turns
        the offload off."""
        from fleetx_tpu_torch.parallel.auto_layout import (advice_inputs,
                                                           offload_is_needed)
        from fleetx_tpu_torch.utils.config import layout_budget_gb

        data_world = (int(dist.get("dp_degree") or 1)
                      * int(dist.get("fsdp_degree") or 1))
        mdl, mb, gran = advice_inputs(self.cfg, data_world=data_world)
        hbm_gb, _ = layout_budget_gb(dist.get("auto_layout"), self.device)
        if not offload_is_needed(mdl, dist, micro_batch=mb, recompute=gran,
                                 hbm_gb=hbm_gb):
            logger.warning(
                "sharding_offload is on but the step estimate fits HBM "
                "without it — offload costs ~2.8x step time and should "
                "only be used when the model otherwise does not fit")
        logger.warning("sharding_offload requires a TPU backend; "
                       "continuing without offload")
        self.sharding_offload = False

    # ------------------------------------------------------------ state
    def prepare(self) -> dict:
        """Seeded parameters (unless already set) and optimizer state; in
        eval mode the checkpoint's parameters, or seeded ones with a
        warning."""
        if self.mode != "train":
            self._prepare_eval()
            if self.mesh is not None and self._plan is None:
                self._shard_params()
            return self.params
        if self.params is None:
            t0 = time.time()
            self.params = self.module.init_params(self.seed, self.device)
            n = sum(p.numel() for _, p in tree_leaves_with_path(self.params))
            logger.info("initialized parameters in %.1fs (%d params)",
                        time.time() - t0, n)
        if self.mesh is not None and self._plan is None:
            self._shard_params()
        self._leaves = [p for _, p in tree_leaves_with_path(self.params)]
        for p in self._leaves:
            if p.device != self.device:
                raise ValueError(f"parameter on {p.device}, engine on "
                                 f"{self.device}")
            p.requires_grad_(True)
        if self.optimizer is not None and self.opt_state is None:
            self.opt_state = self.optimizer.init(self._moment_template())
        if self.async_save and self.device.type == "cuda":
            # pinned once here, not by a save while training
            ckpt_lib.reserve_host_buffers(self.state_dict())
        if self.obs.enabled and self.obs.derived is None:
            fpt = self.module.flops_per_token() \
                if hasattr(self.module, "flops_per_token") else None
            self.obs.init_derived(fpt, self.mesh.size if self.mesh else 1,
                                  device=self.device)
            if self.mesh is not None and self._stage >= 2:
                # bytes of the grad leaves stage 2 spreads over fsdp
                self.obs.registry.gauge("grad_bytes_sharded").set(float(sum(
                    int(np.prod(pl.shape)) * leaf.element_size()
                    for pl, spec, leaf in zip(self._plans, self._grad_specs,
                                              self._leaves)
                    if SH.dim_of(spec, "fsdp") is not None)))
        if self.obs.enabled and self.mem is None:
            # device-memory attribution: the measured peak scored against
            # the planner's prediction for this config
            device = self.device
            self.mem = MemoryMonitor(
                registry=self.obs.registry,
                predicted_bytes=self._predicted_hbm_bytes(),
                stats_fn=lambda: memory_mod.sample_memory_stats(device))
        if self.ckpt_dir and self._restored is None:
            self._restored = False
            self.load(self.ckpt_dir)
        return self.params

    # ------------------------------------------------------------- gang
    @property
    def _stage(self) -> int:
        dist = dict(self.cfg.get("Distributed") or {})
        return int((dist.get("sharding") or {}).get("sharding_stage") or 0)

    def _shard_params(self) -> None:
        """Cut the full tree to this rank's blocks under the plan, and run
        the module on the mesh."""
        dist = dict(self.cfg.get("Distributed") or {})
        model = dict(self.cfg.get("Model") or {})
        sp = bool(dist.get("sequence_parallel")
                  or model.get("sequence_parallel"))
        layout = SpecLayout(stage=self._stage, sequence_parallel=sp)
        family = getattr(self.module, "spec_family", "gpt")
        overlap = bool((dist.get("sharding") or {}).get("overlap_update"))
        flat = ckpt_lib.flatten(self.params)
        self._plan = SH.plan_leaves({k: tuple(v.shape) for k, v in
                                     flat.items()}, family, layout,
                                    self.mesh, overlap)
        out = {}
        for k, v in flat.items():
            pl = self._plan[k]
            for spec in (pl.stored, pl.moment, pl.grad):
                SH.local_shape(pl.shape, spec, self.mesh)
            block = shard_leaf(v.detach(), pl.stored, self.mesh)
            out[k] = block.clone() if tuple(block.shape) != pl.shape \
                else v.detach()
        self.params = ckpt_lib.unflatten(out)
        self._plans = [self._plan[k] for k in out]
        # the grad's spec after the sync (``_sync_grads``): the block the
        # forward's gather reduce-scattered; at stage 2 and above the
        # gradient spec where the optimizer state is split too; else whole
        # over fsdp (a reduce-scatter whose blocks the update gathers
        # again is an all-reduce)
        self._grad_specs = [
            pl.stored if SH.dim_of(pl.stored, "fsdp") is not None
            else pl.grad if self._stage >= 2
            and SH.dim_of(pl.moment, "fsdp") is not None else pl.stored
            for pl in self._plans]
        # leaves the engine gathers before the loss (overlap_update)
        self._pre_gather = {k: pl.pre_gather for k, pl in self._plan.items()
                            if pl.pre_gather is not None}
        self._sp = sp and self.mesh.shape["tensor"] > 1
        self.module.attach_shard(SH.ShardCtx(
            self.mesh, sequence_parallel=sp,
            gather={k: pl.fwd_gather for k, pl in self._plan.items()
                    if pl.fwd_gather is not None}))
        logger.info("gang rank %d of %d: mesh %s, ZeRO stage %d%s, %d of "
                    "%d parameter leaves split", self.mesh.rank,
                    self.mesh.size, self.mesh.shape, self._stage,
                    " (overlap_update)" if overlap else "",
                    sum(bool(SH.axes_of(pl.stored)) for pl in self._plans),
                    len(self._plans))

    def _moment_template(self) -> dict:
        """The tree the optimizer state is made on: the parameters, or on
        a gang empty tensors of each leaf's optimizer-state block."""
        if self.mesh is None:
            return self.params
        flat = ckpt_lib.flatten(self.params)
        return ckpt_lib.unflatten({
            k: torch.empty(SH.local_shape(pl.shape, pl.moment, self.mesh),
                           dtype=flat[k].dtype, device=self.device)
            for k, pl in self._plan.items()})

    def _forward_params(self, params: dict) -> dict:
        """The tree the loss runs on: the kept leaves, with those
        ``overlap_update`` keeps over ``fsdp`` all-gathered (the reduce-
        scatter of their grads is that gather's backward)."""
        if self.mesh is None or not self._pre_gather:
            return params
        flat = ckpt_lib.flatten(params)
        for k, d in self._pre_gather.items():
            flat[k] = SH.gather_fsdp(flat[k], d, self.mesh)
        return ckpt_lib.unflatten(flat)

    def _rows(self, batch: dict, accumulate: int = 1) -> dict:
        """This rank's rows of a global host batch (all of it on one
        rank)."""
        if self.mesh is None:
            return batch
        return SH.batch_rows(batch, self.mesh, accumulate)

    @property
    def _data_world(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    @torch.no_grad()
    def _sync_grads(self, grads: list) -> list:
        """Every rank's grads → the global grads in each leaf's
        ``_grad_specs`` block. The entries of ``grads`` are released as
        they are synced, so one leaf's raw and synced grads are alive
        together, not the whole tree's twice."""
        mesh, out = self.mesh, []
        for i, (pl, spec) in enumerate(zip(self._plans, self._grad_specs)):
            g, grads[i] = grads[i], None
            if self._sp and "tensor" not in SH.axes_of(pl.stored):
                # a replicated leaf used on sequence blocks
                g = PM.psum(g, "tensor", mesh)
            if SH.dim_of(pl.stored, "fsdp") is not None:
                g = PM.psum(g, "data", mesh)  # reduce-scattered already
            elif SH.dim_of(spec, "fsdp") is not None:
                g = PM.reduce_scatter(g, "fsdp", mesh,
                                      dim=SH.dim_of(spec, "fsdp"))
                g = PM.psum(g, "data", mesh)
            else:
                g = PM.psum_axes(g, SH.DATA_AXES, mesh)
            out.append(g)
        return out

    def _grad_norm(self, grads: list, inv: float) -> torch.Tensor:
        """The global grad norm of a step's grads (synced on a gang)."""
        if self.mesh is None:
            return self.optimizer.grad_norm(list(grads), inv)
        return self._synced_norm(self._sync_grads(list(grads)), inv)

    def _synced_norm(self, grads: list, inv: float) -> torch.Tensor:
        """The global norm of synced grads: each leaf's block counted over
        the axes its spec splits it on."""
        return self.optimizer.grad_norm(
            grads, inv, [SH.axes_of(s) for s in self._grad_specs], self.mesh)

    @torch.no_grad()
    def _sharded_update(self, grads: list, g_norm: torch.Tensor,
                        inv: float) -> None:
        """The optimizer step on each leaf's optimizer-state block, then
        each parameter back in the block the engine keeps."""
        mesh = self.mesh
        params_u, grads_u, after = [], [], []
        for leaf, g, pl, spec in zip(self._leaves, grads, self._plans,
                                     self._grad_specs):
            dm = SH.dim_of(pl.moment, "fsdp")
            dg = SH.dim_of(spec, "fsdp")
            ds = SH.dim_of(pl.stored, "fsdp")
            if dg != dm:
                g = PM.all_gather(g, "fsdp", mesh, dim=dg) if dm is None \
                    else SH.narrow_to(g, pl.moment, "fsdp", mesh)
            p = leaf.detach()
            if ds == dm:
                pu = p
            elif ds is None:  # kept whole, updated on its block
                pu = SH.narrow_to(p, pl.moment, "fsdp", mesh)
                after.append((p, pu, dm, None))
            else:  # kept on a block, updated whole
                pu = PM.all_gather(p, "fsdp", mesh, dim=ds)
                after.append((p, pu, None, pl.stored))
            params_u.append(pu)
            grads_u.append(g)
        self.optimizer.update(params_u, grads_u, self.opt_state,
                              g_norm=g_norm, grad_scale=inv)
        for p, pu, dm, stored in after:
            if dm is not None:
                p.copy_(PM.all_gather(pu, "fsdp", mesh, dim=dm))
            else:
                p.copy_(SH.narrow_to(pu, stored, "fsdp", mesh))

    def _gang_step(self, batch: dict) -> dict:
        """``train_step`` on a gang: the grads synced, the global norm,
        the finite flag as a pmax over the mesh, the sharded update."""
        scale = None if self.scaler is None else \
            float(self.scaler["loss_scale"])
        grads, metrics = self._step_grads(batch, scale)
        if self.lr_schedule is not None:
            metrics["lr"] = float(self.lr_schedule(self.step))
        if self.optimizer is None:
            self.step += 1
            return metrics
        inv = self._inv_scale()
        raw, grads = list(grads), None
        grads = self._sync_grads(raw)
        g_norm = self._synced_norm(grads, inv)
        finite = True
        if self.check_finite:
            bad = (~(torch.isfinite(g_norm) & torch.isfinite(
                metrics["loss"]))).float()
            for axis in MESH_AXES:
                bad = PM.pmax(bad, axis, self.mesh)
            finite = not bool(bad)
        if finite:
            with self.obs.timed_span("optimizer_update"):
                self._sharded_update(grads, g_norm, inv)
            self.step += 1
        metrics["grad_norm"] = g_norm
        if self.check_finite:
            metrics["finite"] = finite
            if self.scaler is not None:
                self._update_scaler(finite)
                metrics["loss_scale"] = float(self.scaler["loss_scale"])
        return metrics

    def full_params(self) -> dict:
        """The whole parameter tree (gathered on a gang; the live tensors
        on one rank)."""
        if self.mesh is None:
            return self.params
        return ckpt_lib.unflatten({
            k: SH.gather_leaf(v.detach(), self._plan[k].stored, self.mesh)
            for k, v in ckpt_lib.flatten(self.params).items()})

    def _full_state(self) -> dict:
        """``state_dict`` with every leaf whole, what a one-rank run's
        checkpoint holds, for rank 0 (each leaf moved to host memory as it
        is gathered, so the card holds one at a time); the other ranks
        take part in every gather and keep None."""
        state = self.state_dict()
        for k, v in list(state.items()):
            spec = self._state_spec(k)
            if spec is not None:
                full = SH.gather_leaf(v.detach(), spec, self.mesh)
                state[k] = full.cpu() if self.mesh.rank == 0 else None
        return state

    def _state_spec(self, key: str):
        """The spec of a state leaf on the gang: a parameter's kept spec,
        an optimizer-state leaf's ``moment`` spec; None for the rest."""
        if key.startswith("params/"):
            return self._plan[key[len("params/"):]].stored
        name = key.split("/", 2)
        if key.startswith("opt_state/") and len(name) == 3 and \
                name[2] in self._plan:
            return self._plan[name[2]].moment
        return None

    def _cut_state(self, state: dict) -> dict:
        """A loaded full state cut to this rank's blocks."""
        out = dict(state)
        for k, v in state.items():
            spec = self._state_spec(k)
            if spec is not None:
                out[k] = shard_leaf(v, spec, self.mesh)
        return out

    def _prepare_eval(self) -> dict:
        """Parameters for eval and inference: from ``ckpt_dir`` (params
        only) when it holds a checkpoint, else seeded with a warning."""
        if self.params is not None:
            return self.params
        step = ckpt_lib.latest_step(self.ckpt_dir) if self.ckpt_dir \
            else None
        if step is not None:
            self.params = ckpt_lib.load_params(self.ckpt_dir, step,
                                               device=self.device)
            self.module.check_params(self.params)
        else:
            logger.warning(
                "NO CHECKPOINT FOUND (ckpt_dir=%r) — %s RANDOMLY "
                "INITIALIZED weights; the numbers below are meaningless for "
                "any trained model", self.ckpt_dir,
                "evaluating" if self.mode == "eval" else "exporting")
            self.params = self.module.init_params(self.seed, self.device)
        return self.params

    def to_device(self, batch: dict) -> dict:
        """Host numpy batch → tensors on the engine's device (pinned,
        non-blocking copies to a card, on the current stream: the compute
        stream in the step, the prefetcher's copy stream on its
        producer thread)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------- step
    def _grads(self, batch: dict, loss_scale: Optional[float], params: dict,
               leaves: list, step: int):
        # the forward and the backward marked for the profiler window's
        # trace decomposition (the JAX scan regions' labels)
        with self.profiler.annotate("fwd_scan"):
            loss, metrics = self.module.training_loss(
                self._forward_params(params), batch, self.seed, step)
            if loss_scale is not None:
                loss = loss * loss_scale
        with self.profiler.annotate("bwd_scan"):
            grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def _step_grads(self, batch: dict, scale: Optional[float],
                    params: Optional[dict] = None,
                    leaves: Optional[list] = None,
                    step: Optional[int] = None) -> tuple:
        """``(grads, metrics)`` of a step: the forward and backward of
        every microbatch at ``step``'s dropout, summed in the carry dtype
        and averaged when ``accumulate_steps > 1``. The live parameters
        unless the sentinel's replay passes its copies."""
        params = self.params if params is None else params
        leaves = self._leaves if leaves is None else leaves
        step = self.step if step is None else step
        accum = self.accumulate_steps
        if accum > 1:
            lead = leading_dim(batch)
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
                g, m = self._grads(micro, scale, params, leaves, step)
                if grads is None:
                    grads = [x.to(carry_dtype or x.dtype) for x in g]
                    metrics = m
                else:
                    grads = [a + x.to(a.dtype) for a, x in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [(g / accum).to(p.dtype)
                     for g, p in zip(grads, leaves)]
            metrics = {k: v / accum for k, v in metrics.items()}
        else:
            grads, metrics = self._grads(batch, scale, params, leaves, step)
        return grads, metrics

    def _inv_scale(self) -> float:
        """1 / loss_scale in f32 (1.0 without the scaler); AdamW folds it
        into its moment updates."""
        return 1.0 if self.scaler is None else \
            float(np.float32(1.0) / self.scaler["loss_scale"])

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a device batch; returns the metrics
        (device tensors, and host values for ``lr``, ``finite`` and
        ``loss_scale``). Under ``check_finite`` a non-finite step changes
        no parameter, moment or counter (only the loss scale)."""
        if self.mesh is not None:
            return self._gang_step(batch)
        scale = None if self.scaler is None else \
            float(self.scaler["loss_scale"])
        grads, metrics = self._step_grads(batch, scale)
        if self.lr_schedule is not None:
            metrics["lr"] = float(self.lr_schedule(self.step))
        if self.optimizer is None:
            self.step += 1
            return metrics
        inv = self._inv_scale()
        if not self.check_finite:
            with self.obs.timed_span("optimizer_update"):
                metrics["grad_norm"] = self.optimizer.update(
                    self._leaves, list(grads), self.opt_state,
                    grad_scale=inv)
            self.step += 1
            return metrics
        g_norm = self.optimizer.grad_norm(grads, inv)
        # the step's one host sync: the next step's LR and dropout seeds
        # depend on whether this one counts
        finite = bool(torch.isfinite(g_norm) & torch.isfinite(
            metrics["loss"]))
        if finite:
            with self.obs.timed_span("optimizer_update"):
                self.optimizer.update(self._leaves, list(grads),
                                      self.opt_state, g_norm=g_norm,
                                      grad_scale=inv)
            self.step += 1
        metrics["grad_norm"] = g_norm
        metrics["finite"] = finite
        if self.scaler is not None:
            self._update_scaler(finite)
            metrics["loss_scale"] = float(self.scaler["loss_scale"])
        return metrics

    def _update_scaler(self, finite: bool) -> None:
        """Grow the scale x2 after ``GROWTH_INTERVAL`` finite steps in a
        row, halve it on a non-finite one (f32 arithmetic, as the JAX
        ``ScalerState`` update)."""
        scale = self.scaler["loss_scale"]
        tracker = self.scaler["growth_tracker"] + np.int32(1) if finite \
            else np.int32(0)
        grow = bool(tracker >= GROWTH_INTERVAL)
        if not finite:
            scale = scale * np.float32(0.5)
        elif grow:
            scale = scale * np.float32(2.0)
        self.scaler = {"loss_scale": np.float32(scale),
                       "growth_tracker": np.int32(0 if grow else tracker)}

    # -------------------------------------------------------------- fit
    def fit(self, train_data_loader: Iterable, valid_data_loader=None,
            epoch_num: int = 1) -> list:
        """Train until ``max_steps``, re-iterating the loader (in the
        ``epoch`` run mode, also until ``epoch_num`` passes are done);
        returns the logged losses. The resilience runtime's hooks are
        inert unless ``Resilience.enable``."""
        res = self.resilience
        if res.auto_resume and self._restored is None:
            self._auto_resume()
        self.prepare()
        losses: list = []
        if self.step >= self.max_steps:
            return losses
        if self.run_mode == "epoch" and self.epoch >= epoch_num:
            logger.info("checkpoint already at epoch %d >= epoch_num %d",
                        self.epoch, epoch_num)
            return losses
        if self._restored and \
                not _rewind_sampler(train_data_loader, self.consumed_samples):
            logger.warning("resume: the loader has no consumed_samples "
                           "sampler — assuming the stream is already at "
                           "global sample %d", self.consumed_samples)
        start_step = self.step
        # the sample position at entry: a rollback without a
        # consumed_samples sampler skips forward from here
        base_consumed = self.consumed_samples
        stream: dict = {"batches": None, "loader_iter": None,
                        "prefetcher": None}
        # the epoch a cleanly exhausted stream ended at (the "epoch" meta
        # of the run's last save)
        final_epoch = [self.epoch]

        def host_batches(index: int):
            """``(epoch, batch)`` pairs from the loader, re-iterated over
            epochs from ``self.epoch`` on, each batch through the fault
            plan at its global step index ``index``. Only the consumer
            sets ``self.epoch`` (from the pairs), so a save never records
            an epoch the training loop has not reached."""
            epoch = final_epoch[0] = self.epoch
            while True:
                it = iter(train_data_loader)
                stream["loader_iter"] = it
                got = False
                for batch in it:
                    got = True
                    yield epoch, res.faults.on_batch(
                        index, self.module.pretreating_batch(batch))
                    index += 1
                epoch += 1
                final_epoch[0] = epoch
                if not got or (self.run_mode == "epoch"
                               and epoch >= epoch_num):
                    return

        def wrap_stream(batches) -> None:
            """Make ``batches`` the active source, behind the device
            prefetcher when ``prefetch_to_device`` > 0 (a producer thread
            copies batch N+1 while step N runs; the consumer's wait is then
            pure input starvation)."""
            stream["batches"] = batches
            if self.prefetch_to_device > 0:
                stream["prefetcher"] = DevicePrefetcher(
                    batches, lambda eb: (eb[0], self.to_device(self._rows(
                        eb[1], self.accumulate_steps))),
                    depth=self.prefetch_to_device, obs=self.obs,
                    device=self.device)

        def close_stream() -> bool:
            """Tear the input pipeline down in dependency order: the
            prefetcher (joins its producer, leaving the batch generator
            suspended), the batch generator, then the loader iterator (which
            joins a prefetching loader's producer thread, so nothing moves
            the sampler afterwards). False when the prefetcher's producer
            did not exit in time: the generators are then left to GC, and
            the no-live-producer guarantee does not hold."""
            ok = True
            pf, stream["prefetcher"] = stream["prefetcher"], None
            if pf is not None:
                ok = pf.close()
                if not ok:
                    logger.error("prefetch producer did not exit within "
                                 "its join timeout — leaving the input "
                                 "pipeline to GC")
            for key in ("batches", "loader_iter"):
                gen, stream[key] = stream[key], None
                if ok and gen is not None and hasattr(gen, "close"):
                    gen.close()
            return ok

        def fetch_item():
            """One ``(epoch, batch)`` from the prefetcher when armed, else
            the batch generator, under the ``data_fetch`` span; None when
            the stream ran dry."""
            src = stream["prefetcher"] if stream["prefetcher"] is not None \
                else stream["batches"]
            with self.obs.timed_span("data_fetch"):
                return next(src, None)

        def on_stall() -> None:
            """Watchdog stall: durable-ize telemetry and the flight ring."""
            self.obs.flush()
            flight.dump("watchdog_stall")

        watchdog = res.make_watchdog(on_stall=on_stall)

        def quiet():
            """Suspend the stall detector around a known-long host phase
            (checkpoint, restore, eval)."""
            return (watchdog.suspended() if watchdog is not None
                    else contextlib.nullcontext())

        t_last = time.time()
        window = 0
        last_eval = last_save = -1  # a skipped step can re-visit a step
        global_batch = 0
        # the SDC sentinel's cadence: 0 keeps the loop as it is without it
        sent_every = res.sentinel_every if self.optimizer is not None \
            else 0
        with contextlib.ExitStack() as cleanup:
            cleanup.callback(close_stream)
            # a fit that raises leaves no profiler window open
            cleanup.callback(self.profiler.cancel)

            def flight_on_crash(exc_type, exc, tb):
                """Dump the flight ring on any abnormal exit (the graceful
                preemption exit dumps for itself)."""
                if exc_type is not None and \
                        not issubclass(exc_type, SystemExit):
                    flight.note("crash", exc_type.__name__,
                                error=str(exc)[:300])
                    flight.dump(f"crash:{exc_type.__name__}")
                return False  # never suppress the exception

            cleanup.push(flight_on_crash)
            if res.preemption is not None:
                # previous SIGTERM/SIGINT handlers come back on every exit
                cleanup.enter_context(res.preemption.installed())
            if watchdog is not None:
                watchdog.start()
                cleanup.callback(watchdog.stop)
            self.profiler.arm()  # each fit gets its own trace window
            wrap_stream(host_batches(start_step))
            first_step = True
            while self.step < self.max_steps:
                res.faults.maybe_sigterm(self.step, start_step=start_step)
                if res.preempted:
                    self._preemption_exit(quiet)
                item = fetch_item()
                if item is None:
                    self.epoch = final_epoch[0]
                    break  # fleetx: noqa[FX008] -- one process (world-1 coordinator); the gang's voted exit comes with item 12
                self.epoch, batch = item
                self.profiler.maybe_start(self.step)
                # a sentinel step keeps what its replay needs from before
                # the step (the JAX engine runs it through its non-donating
                # twin for that)
                prev = self._sentinel_snapshot() if sent_every and \
                    (self.step + 1) % sent_every == 0 else None
                with self.profiler.step_span(self.step):
                    if stream["prefetcher"] is None:
                        with self.obs.timed_span("shard_batch"):
                            batch = self.to_device(self._rows(
                                batch, self.accumulate_steps))
                    # the span covers the host's launches, not the card's
                    # time (the step runs asynchronously)
                    with self.obs.span("train_step", step=self.step):
                        metrics = self.train_step(batch)
                if prev is not None:
                    # the replay is a full forward and backward: the stall
                    # detector is suspended as for every long host phase;
                    # ``batch`` stays referenced until it is done (the
                    # prefetcher's record_stream keeps its memory valid)
                    with self.obs.timed_span("sdc_sentinel"), quiet():
                        self._sdc_check(prev, batch, metrics, self.step)
                    prev = None
                if res.faults.take_bitflip(self.step):
                    # after this iteration's check, as the JAX engine
                    self._apply_bitflip()
                global_batch = leading_dim(batch) * self._data_world
                if first_step:
                    first_step = False
                    self._perf_flops_per_step = self._flops_per_step(
                        global_batch)
                    if self.mem is not None:
                        self.mem.sample("first_step")
                self.consumed_samples += global_batch
                window += 1
                if watchdog is not None:
                    watchdog.beat(self.step)
                if window % self.logging_freq == 0:
                    loss = float(metrics["loss"])  # one sync per window
                    now = time.time()
                    cost = (now - t_last) / self.logging_freq
                    t_last = now
                    losses.append(loss)
                    grad_norm = metrics.get("grad_norm")
                    record = {
                        "global_step": self.step, "epoch": self.epoch,
                        "batch": window, "loss": loss, "train_cost": cost,
                        "global_batch_size": global_batch,
                        "lr": metrics.get("lr", 0.0), "device": self.device,
                        "grad_norm": None if grad_norm is None
                        else float(grad_norm)}
                    if "loss_scale" in metrics:
                        record["loss_scale"] = metrics["loss_scale"]
                    self.module.training_step_end(record)
                    self.history.append(record)
                    self._emit_train_record(record)
                    if res.guard is not None:
                        decision = coordination.most_severe(
                            self.coord.all_gather(
                                "guard_decision", res.guard.observe(
                                    self.step, loss,
                                    finite=metrics.get("finite"))).values())
                        if decision is not None:
                            flight.note("guard", str(decision),
                                        step=self.step, loss=loss)
                        if decision == "rollback":
                            if not close_stream():
                                raise TrainingAborted(
                                    "rollback aborted: the input pipeline "
                                    "did not shut down cleanly, the data "
                                    "position cannot be safely rewound")
                            with quiet():
                                wrap_stream(self._rollback(
                                    train_data_loader, host_batches,
                                    base_consumed, global_batch))
                            if self.logging_freq == 1:
                                # the curve follows the rewound counter
                                del losses[max(self.step - start_step, 0):]
                            window = 0
                            t_last = time.time()
                            # the replay re-saves / re-evaluates the steps
                            # the abandoned run already visited
                            last_eval = last_save = self.step
                            continue
                        if decision == "abort":
                            raise TrainingAborted(
                                f"training guard abort at step {self.step} "
                                f"(loss={loss})")
                # the window closes after draining the card, so its trace
                # holds every kernel of its steps
                self.profiler.maybe_stop(self.step)
                if self.eval_freq and valid_data_loader is not None and \
                        self.step % self.eval_freq == 0 and \
                        self.step != last_eval:
                    last_eval = self.step
                    with quiet():
                        self.evaluate(valid_data_loader,
                                      global_step=self.step)
                if self.save_steps and self.step % self.save_steps == 0 \
                        and self.step != last_save:
                    last_save = self.step
                    with quiet():
                        self.save()
                if self._fault_step and start_step == 0 and \
                        self.step >= self._fault_step:
                    # the restart drill: a fresh run dies hard after this
                    # step's save; a resumed run sails past
                    logger.error("fault injection: dying at step %d",
                                 self.step)
                    os._exit(17)
            self.profiler.stop()
            with quiet():  # an outstanding write can take ~20 s
                ckpt_lib.finalize_async_saves()
            if self.keep_last:
                ckpt_lib.gc_checkpoints(self.output_dir, self.keep_last,
                                        self.keep_every)
            self.obs.flush()
        return losses

    def _preemption_exit(self, quiet) -> None:
        """Graceful shutdown at a step boundary: save the step (unless
        ``save_on_exit`` is off), count ``preemption_exits``, note it in
        the flight recorder, exit with ``preemption.exit_code``."""
        res = self.resilience
        logger.warning("preemption: checkpoint-and-exit at step %d",
                       self.step)
        if res.preemption_save:
            t0 = time.perf_counter()
            with quiet():
                self.save()
                ckpt_lib.finalize_async_saves()
            logger.warning("preemption: saved step %d in %.3f s", self.step,
                           time.perf_counter() - t0)
        res.registry.counter("preemption_exits").inc()
        flight.note("preemption", "exit", step=self.step)
        flight.dump("preemption")
        self.obs.flush()
        raise SystemExit(res.preemption_exit_code)

    def _rollback(self, loader, host_batches, base_consumed: int,
                  global_batch: int):
        """Guard rollback: restore the newest completed step under
        ``output_dir`` (falling back past a corrupt one), point the data
        stream at its position and return the new batch generator. The
        caller has closed the old stream, so no producer thread moves the
        sampler during the rewind."""
        res = self.resilience
        self.coord.barrier("rollback_enter")
        ckpt_lib.finalize_async_saves()
        good = self.coord.broadcast("rollback_step",
                                    ckpt_lib.latest_step(self.output_dir))
        if good is None:
            raise TrainingAborted(
                f"rollback requested at step {self.step} but no completed "
                f"checkpoint under {self.output_dir}")
        t0 = time.perf_counter()
        self.load(self.output_dir)
        logger.warning("rollback: restored step %d in %.3f s", self.step,
                       time.perf_counter() - t0)
        skip = 0
        if not _rewind_sampler(loader, self.consumed_samples):
            # no consumed_samples sampler: re-iterate the loader and skip
            # forward to the restored position (a one-shot iterator is
            # gone)
            if iter(loader) is loader:
                raise TrainingAborted(
                    "rollback needs a re-iterable data loader or a sampler "
                    "with consumed_samples")
            skip = max((self.consumed_samples - base_consumed)
                       // max(global_batch, 1), 0)
        batches = host_batches(self.step - skip)
        for _ in range(skip):
            if next(batches, None) is None:
                raise TrainingAborted(  # fleetx: noqa[FX008] -- one process (world-1 coordinator); the gang's vote comes with item 12
                    "data stream exhausted while rewinding for rollback")
        res.registry.counter("rollbacks_total").inc()
        if res.guard is not None:
            res.guard.note_rollback()
        flight.note("rollback", "restored", step=self.step)
        logger.warning("rolled back to checkpoint step %d", self.step)
        self.coord.barrier("rollback_exit")
        return batches

    def _auto_resume(self) -> None:
        """Point ``ckpt_dir`` at ``ckpt_dir`` or ``output_dir`` when its
        newest checkpoint verifies, so ``prepare`` restores it (and
        ``fit`` rewinds the sampler to its position)."""
        target = self.ckpt_dir or self.output_dir
        meta = self.coord.broadcast(
            "resume_meta", ckpt_lib.peek_meta(target) if target else None)
        if not meta:
            return
        self.ckpt_dir = target
        logger.info("auto-resume: restoring step %s from %s",
                    meta.get("step"), target)

    # ----------------------------------------------------- SDC sentinel
    def _sentinel_snapshot(self) -> dict:
        """What the replay needs from before a step: a clone of the
        parameters (same nesting and leaf order), the step counter, the
        loss scale and its inverse."""
        def clone(node):
            if isinstance(node, dict):
                return {k: clone(v) for k, v in node.items()}
            return node.detach().clone().requires_grad_(True)

        params = clone(self.params)
        return {"params": params,
                "leaves": [p for _, p in tree_leaves_with_path(params)],
                "step": self.step,
                "scale": None if self.scaler is None
                else float(self.scaler["loss_scale"]),
                "inv": self._inv_scale()}

    def _replay(self, prev: dict, batch: dict) -> dict:
        """The step's forward and backward again on the state from before
        it, and its ``grad_norm`` by the function the step used (the
        optimizer's ``grad_norm``, inside ``update`` or before it); no
        update, no counter moves."""
        grads, metrics = self._step_grads(batch, prev["scale"],
                                          prev["params"], prev["leaves"],
                                          prev["step"])
        metrics["grad_norm"] = self._grad_norm(grads, prev["inv"])
        return metrics

    def _sdc_check(self, prev: dict, batch: dict, metrics: dict,
                   step: int) -> None:
        """One SDC sentinel check: replay the step and compare ``loss``
        and ``grad_norm`` with the step's bit for bit; on a mismatch act
        on ``sentinel_action`` (``log | quarantine | abort``). One rank:
        no fingerprint census (item 12), as JAX's off-gang check."""
        res = self.resilience
        reg = res.registry
        reg.counter("sdc_checks_total").inc()
        replay = self._replay(prev, batch)
        evidence = []
        for key in ("loss", "grad_norm"):
            if key not in metrics or key not in replay:
                continue
            a = np.asarray(torch.as_tensor(metrics[key]).detach().cpu())
            b = np.asarray(replay[key].detach().cpu())
            if a.tobytes() != b.tobytes():
                evidence.append(f"replay {key}: {a!r} != {b!r}")
        if not evidence:
            return
        reg.counter("sdc_replay_mismatches").inc()
        flight.note("sdc", "mismatch", step=int(step), evidence=evidence)
        msg = f"SDC sentinel tripped at step {step}: " + "; ".join(evidence)
        if res.sentinel_action == "abort":
            logger.error("%s — aborting (sentinel_action: abort)", msg)
            raise TrainingAborted(msg)
        if res.sentinel_action == "quarantine":
            reg.counter("sdc_quarantines").inc()
            marker = os.path.join(self.output_dir, "sdc_quarantine.json")
            os.makedirs(self.output_dir, exist_ok=True)
            atomic_write(marker, lambda f: json.dump(
                {"step": int(step), "rank": int(self.coord.rank),
                 "evidence": evidence,
                 "quarantines": int(reg.counter("sdc_quarantines").value)},
                f))
            logger.error("%s — host quarantined (marker: %s); training "
                         "continues, schedule this host for replacement",
                         msg, marker)
            return
        logger.error("%s — continuing (sentinel_action: log)", msg)

    @torch.no_grad()
    def _apply_bitflip(self) -> None:
        """The ``bitflip_param_at`` drill: flip bit 0 of byte 0 of the
        first element of the first float parameter in JAX's leaf order,
        in place on its device (the element the JAX engine's drill flips
        on the same converted tree)."""
        for i, leaf in enumerate(jax_leaves(self.params)):
            if not leaf.is_floating_point() or leaf.numel() < 1:
                continue
            leaf.detach().view(-1)[:1].view(torch.uint8)[:1].bitwise_xor_(1)
            logger.warning("fault injection: flipped one bit in param "
                           "leaf %d", i)
            return
        logger.warning("fault injection: no float param leaf to bit-flip")

    # -------------------------------------------------------- telemetry
    def _flops_per_step(self, batch_rows: int) -> Optional[float]:
        """Model FLOPs of one step for the trace decomposition's roofline;
        None for a module without a FLOPs count (the report then ranks the
        raw category costs)."""
        fpt = self.module.flops_per_token() \
            if hasattr(self.module, "flops_per_token") else None
        tps = getattr(self.module, "tokens_per_sample", None)
        if not fpt or not tps:
            return None
        return float(fpt) * int(tps) * int(batch_rows)

    def _predicted_hbm_bytes(self) -> Optional[float]:
        """The planner's per-device memory prediction for this config
        (``parallel/auto_layout.predicted_step_bytes``), or None for a
        module its GPT-family model cannot describe."""
        if not self.cfg.get("Model") or \
                not hasattr(self.module, "flops_per_token"):
            return None
        try:
            from fleetx_tpu_torch.parallel.auto_layout import (
                advice_inputs, predicted_step_bytes)

            mdl, mb, gran = advice_inputs(self.cfg,
                                          data_world=self._data_world)
            return predicted_step_bytes(
                mdl, dict(self.cfg.get("Distributed") or {}), mb, gran)
        except Exception as e:  # noqa: BLE001 — advisory, never fatal
            logger.warning("hbm prediction unavailable: %s: %s",
                           type(e).__name__, e)
            return None

    def _on_profiler_stop(self, trace_dir: str) -> None:
        """Decompose the just-closed profiler window into the MFU-gap
        report and land it in ``perf.jsonl``, the gauges and the flight
        ring. Best-effort: a failed analysis logs and training goes on."""
        obs = self.obs
        if not obs.perf_enabled:
            return
        try:
            from fleetx_tpu_torch.observability import perf
            from fleetx_tpu_torch.utils.hardware import roofline

            name = torch.cuda.get_device_name(self.device) \
                if self.device.type == "cuda" else ""
            report = perf.analyze(
                trace_dir, flops_per_step=self._perf_flops_per_step,
                roofline=roofline(name), top_k=obs.perf_top_k)
            if self.mem is not None:
                self.mem.sample("profile_stop")
                report["hbm"] = self.mem.snapshot()
            self._perf_report = report
            obs.emit_perf(report)
            gap = report.get("mfu_gap") or {}
            top = ", ".join(
                f"{c['name']} {c['ms_per_step']:.1f}ms"
                for c in (gap.get("contributors") or [])[:3])
            logger.info("trace decomposition: step %.1f ms, mfu %s — top "
                        "gap: %s", report["step_ms"], gap.get("mfu"), top)
        except Exception as e:  # noqa: BLE001 — telemetry never kills a run
            logger.warning("trace decomposition failed for %s: %s: %s",
                           trace_dir, type(e).__name__, e)

    def _emit_train_record(self, log_dict: dict) -> None:
        """One machine-readable record per logging window → the sinks,
        with the schema's required keys (``tokens_per_sec`` / ``mfu`` null,
        not absent, when underivable)."""
        obs = self.obs
        if not obs.enabled:
            return
        derived = {}
        if obs.derived is not None:
            derived = obs.derived.update(
                log_dict["train_cost"], log_dict["global_batch_size"],
                tokens_per_sample=getattr(self.module, "tokens_per_sample",
                                          None),
                steps_in_window=self.logging_freq,
                stall_seconds_total=obs.stall_seconds_total())
        record = {
            "ts": time.time(),
            "step": int(log_dict["global_step"]),
            "epoch": int(log_dict.get("epoch", 0)),
            "loss": float(log_dict["loss"]),
            "step_time": float(log_dict["train_cost"]),
            "tokens_per_sec": None,
            "mfu": None,
            "lr": float(log_dict.get("lr", 0.0)),
            "global_batch_size": int(log_dict["global_batch_size"]),
            "engine": self._engine_kind,
        }
        record.update(derived)
        if self.mem is not None:
            # one sample a window: peak / live gauges and the model error
            self.mem.sample("steady_state")
            record.update(self.mem.record_keys())
        if log_dict.get("grad_norm") is not None:
            record["grad_norm"] = float(log_dict["grad_norm"])
        if "loss_scale" in log_dict:
            record["loss_scale"] = float(log_dict["loss_scale"])
        obs.registry.gauge("loss").set(record["loss"])
        obs.registry.histogram("step_time").record(record["step_time"])
        obs.emit(record)

    @torch.no_grad()
    def evaluate(self, valid_data_loader: Iterable,
                 global_step: int = 0) -> float:
        """Mean validation loss over at most ``eval_iters`` batches."""
        self.prepare()
        total, count = 0.0, 0
        t0 = time.time()
        with self.obs.timed_span("eval", global_step=int(global_step)):
            for i, batch in enumerate(valid_data_loader):
                if i >= self.eval_iters:
                    break
                batch = self.to_device(self._rows(
                    self.module.pretreating_batch(batch)))
                loss, _ = self.module.validation_loss(
                    self._forward_params(self.params), batch)
                total += float(loss)
                count += 1
        if self.mem is not None:
            self.mem.sample("eval")
        if count:
            self.module.validation_step_end({
                "global_step": global_step, "batch": count,
                "loss": total / count,
                "eval_cost": (time.time() - t0) / count})
        return total / max(count, 1)

    @torch.no_grad()
    def predict(self, data_loader: Iterable, max_batches: int = 0) -> list:
        """``module.predict_step`` over the loader (at most
        ``max_batches`` batches when set): one host numpy array per
        batch (on a gang every rank returns the whole batch)."""
        self.prepare()
        outputs = []
        for i, batch in enumerate(data_loader):
            if max_batches and i >= max_batches:
                break
            batch = self.to_device(self._rows(
                self.module.pretreating_batch(batch)))
            out = self.module.predict_step(self._forward_params(self.params),
                                           batch)
            if self.mesh is not None:  # the rows of every data rank
                for axis in ("fsdp", "data"):
                    out = PM.all_gather(out, axis, self.mesh)
            outputs.append(out.float().cpu().numpy()
                           if out.dtype == torch.bfloat16
                           else out.cpu().numpy())
        return outputs

    def inference(self, data: list) -> list:
        """Numpy inputs through the exported program of
        ``Inference.model_dir`` (the ``InferenceEngine``, loaded on the
        first call onto the engine's device): numpy outputs."""
        if getattr(self, "_inference_engine", None) is None:
            from fleetx_tpu_torch.core.engine.inference_engine import \
                InferenceEngine

            inf = dict(self.cfg.get("Inference") or {})
            self._inference_engine = InferenceEngine(
                inf.get("model_dir", "./exported"), device=self.device)
        return self._inference_engine.predict(data)

    # ------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        """The flat training state a checkpoint holds: ``step``,
        ``params/<path>``, ``opt_state/<name>`` (the optimizer's
        ``flat_state``: ``AdamW``'s, or the adapters' alone under
        ``lora_optimizer``) and, under the fp16 scaler,
        ``scaler/loss_scale`` (f32) and ``scaler/growth_tracker`` (i32);
        the tensors themselves, not copies."""
        state = {"step": self.step}
        state.update(ckpt_lib.flatten(self.params, "params/"))
        if self.opt_state is not None:
            flat = self.optimizer.flat_state(self.opt_state, self.params)
            state.update({f"opt_state/{k}": v for k, v in flat.items()})
        if self.scaler is not None:  # 0-d, as the JAX ScalerState leaves
            state.update({f"scaler/{k}": torch.tensor(v)
                          for k, v in self.scaler.items()})
        return state

    def save(self) -> str:
        """Save the state at the current step under ``output_dir`` with
        meta ``consumed_samples`` / ``epoch`` / ``seed`` (asynchronously
        under ``async_save``), then apply the retention (the newest
        completed step always survives; an outstanding save is not yet
        completed). On a gang every leaf is gathered, rank 0 writes and
        the ranks meet at a barrier (``core/checkpoint.save_gang``)."""
        self.prepare()
        if self.mesh is not None:
            with self.obs.span("checkpoint_save", step=self.step):
                path = ckpt_lib.save_gang(
                    self.output_dir, self.step, self._full_state(),
                    meta={"consumed_samples": self.consumed_samples,
                          "epoch": self.epoch, "seed": self.seed},
                    mesh=self.mesh, keep_last=self.keep_last,
                    keep_every=self.keep_every)
            self.last_saved_step = self.step
            return path
        # span only: the seconds and bytes are core/checkpoint.py's
        with self.obs.span("checkpoint_save", step=self.step):
            path = ckpt_lib.save_checkpoint(
                self.output_dir, self.step, self.state_dict(),
                meta={"consumed_samples": self.consumed_samples,
                      "epoch": self.epoch, "seed": self.seed},
                async_save=self.async_save)
        if self.mem is not None:
            self.mem.sample("checkpoint_save")
        self.last_saved_step = self.step
        if self.keep_last:
            ckpt_lib.gc_checkpoints(self.output_dir, self.keep_last,
                                    self.keep_every)
        return path

    def load(self, directory: Optional[str] = None) -> bool:
        """Restore the newest completed step under ``directory`` (default
        ``output_dir``) into the engine's params, optimizer state, step
        and data position; True when a step was restored.

        A step that fails digest verification is refused with an error
        log and the newest older completed step is tried, until one
        verifies; if every step fails, this raises. With no completed
        step at all it warns and leaves the fresh state (the first run of
        a command that resumes on restart).
        """
        ckpt_lib.finalize_async_saves()
        directory = directory or self.output_dir
        if self.params is None:
            self.prepare()
        step = ckpt_lib.latest_step(directory)
        refused: list = []
        while True:
            if step is None:
                if refused:
                    raise RuntimeError(
                        f"every checkpoint under {directory} failed "
                        f"integrity verification (refused steps: "
                        f"{refused}) — refusing to restore corrupt state")
                logger.warning("no completed checkpoint under %s — training "
                               "starts from step 0", directory)
                return False
            try:
                state, meta = ckpt_lib.load_checkpoint(directory, step)
                break
            except ckpt_lib.CheckpointIntegrityError as e:
                logger.error("refusing checkpoint step %d: %s", step, e)
                self.resilience.registry.counter(
                    "ckpt_verify_fallbacks").inc()
                refused.append(step)
                older = [s for s in ckpt_lib.completed_steps(directory)
                         if s < step]
                step = older[-1] if older else None
                logger.warning("falling back past corrupt checkpoint step %d "
                               "to the newest older completed step (%s)",
                               refused[-1], step)
        self._apply_state(state)
        self.consumed_samples = int(meta.get("consumed_samples", 0))
        self.epoch = int(meta.get("epoch", 0))
        self._restored = True
        return True

    @torch.no_grad()
    def _apply_state(self, state: dict) -> None:
        """Copy a loaded flat state into the live tensors, bit for bit (on
        a gang the full leaves cut to the rank's blocks); raises on a
        missing or unexpected leaf or a shape that differs."""
        if self.mesh is not None:
            state = self._cut_state(state)
        want = set(self.state_dict())
        have = {k for k in state if self.opt_state is not None
                or not k.startswith("opt_state/")}
        missing, extra = sorted(want - have), sorted(have - want)
        if missing or extra:
            raise ValueError(f"checkpoint does not match this engine's "
                             f"state: missing {missing}, unexpected {extra}")
        for name, p in ckpt_lib.flatten(self.params, "params/").items():
            if tuple(state[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(state[name].shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(state[name])
        if self.opt_state is not None:
            self.optimizer.load_flat_state(
                self.opt_state,
                {k[len("opt_state/"):]: v for k, v in state.items()
                 if k.startswith("opt_state/")}, self.params)
        if self.scaler is not None:
            self.scaler = {
                "loss_scale": np.float32(state["scaler/loss_scale"].item()),
                "growth_tracker": np.int32(
                    state["scaler/growth_tracker"].item())}
        self.step = int(state["step"])


def leading_dim(batch: dict) -> int:
    """The batch size: the leading dim of the batch's first leaf in key
    order (as ``jax.tree.leaves`` orders a dict)."""
    return int(batch[min(batch)].shape[0])


def _rewind_sampler(loader, consumed: int) -> bool:
    """Point a ``consumed_samples`` sampler (``GPTBatchSampler``) at a
    global sample position; False when the loader has none."""
    sampler = getattr(loader, "batch_sampler", None)
    if sampler is not None and hasattr(sampler, "consumed_samples"):
        sampler.consumed_samples = int(consumed)
        logger.info("resume: sampler rewound to consumed_samples=%d",
                    consumed)
        return True
    return False
