"""YAML config loading with ``_base_`` inheritance, dotted overrides and
the training derivations.

The port's copy of ``fleetx_tpu/utils/config.py``: ``AttrDict``,
``_merge``, ``parse_config``, ``_literal``, ``override_config``
(:38-135), ``process_dist_config`` / ``process_global_configs`` /
``process_engine_config`` (:139-241), ``process_observability_config``
(:244-273), ``process_resilience_config`` (:276-330),
``process_serving_config`` (:334-376), ``get_config`` (:379)
and ``parse_args`` (:454), and the engine's fp16 loss-scaler switch
(``fleetx_tpu/core/engine/eager_engine.py:211-214``, ``loss_scaler``).
It reads the same YAML files by path, ``_base_`` chains included (the
generation recipe inherits the 345M one, ``save_steps: 1000`` with it);
sections the loader does not derive (``Generation``, ``Serving`` past
its validation) pass through to their modules. The degrees are JAX's
math against a world size: ``tools/train.py``, ``tools/auto.py`` and the
serving, inference and generation entry points pass their world's size
(``get_config(..., num_devices=N)``); the other loaders are one process
(a world of 1). In the training loader (``get_config(...,
training=True)``) what the sharded training step does not cover yet
raises ``NotImplementedError`` naming ROADMAP.md's port queue item 12
(``check_covered``; the engine checks it too): a pipeline (``pp_degree`` above 1), the ring over
``seq_degree`` above 1, MoE over more than one rank, and tensor or
sequence parallelism or ZeRO stage 3 for a family other than the dense
GPT.

``Distributed.auto_layout`` (a bool, or ``{hbm_gb: N}``) or
``get_config(..., auto_layout=True)`` (``tools/auto.py``) runs the layout
planner (``parallel/auto_layout.suggest_layout``) before the batch
derivations, keeps explicit degrees, and pops the key, as
``fleetx_tpu/utils/config.py:379-432`` does, for the world size it is
given (1 by default).
The planner's budget is ``hbm_gb`` where the YAML gives it; else, on a
CUDA device, the card's own memory
(``torch.cuda.get_device_properties(dev).total_memory``), not the JAX
loader's 16 GB default, which is a TPU figure; on the CPU that default.
At one device the budget changes only whether the planner warns that the
model exceeds it.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Optional

import yaml

__all__ = ["AttrDict", "parse_config", "override_config",
           "process_dist_config", "check_covered", "process_global_configs",
           "process_engine_config", "process_observability_config",
           "process_resilience_config",
           "process_serving_config", "loss_scaler", "layout_budget_gb",
           "plan_layout", "get_config", "parse_args"]


class AttrDict(dict):
    """Recursive attribute-access dict."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo: dict) -> "AttrDict":
        return AttrDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo)
                         for k, v in self.items()})


def create_attr_dict(d: dict) -> AttrDict:
    """Recursively wrap nested dicts as AttrDict."""
    out = AttrDict()
    for k, v in d.items():
        out[k] = create_attr_dict(v) if isinstance(v, dict) else v
    return out


def _merge(base: dict, child: dict) -> dict:
    """Deep-merge ``child`` over ``base``; a child sub-dict carrying
    ``_inherited_: false`` replaces the base sub-dict wholesale."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            if v.get("_inherited_") is False:
                v = {kk: vv for kk, vv in v.items() if kk != "_inherited_"}
                out[k] = copy.deepcopy(v)
            else:
                out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_config(cfg_file: str) -> AttrDict:
    """Load a YAML config, resolving ``_base_`` inheritance recursively."""
    with open(cfg_file, "r") as f:
        raw = yaml.safe_load(f) or {}
    base_file = raw.pop("_base_", None)
    if base_file is not None:
        base_path = os.path.join(os.path.dirname(cfg_file), base_file)
        raw = _merge(parse_config(base_path), raw)
    return create_attr_dict(raw)


def _literal(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def override_config(config: AttrDict,
                    options: list[str] | None = None) -> AttrDict:
    """Apply ``Key.Sub=value`` dotted overrides."""
    if not options:
        return config
    for opt in options:
        if "=" not in opt:
            raise ValueError(f"option '{opt}' must be of form Key.Sub=value")
        key, value = opt.split("=", 1)
        node: Any = config
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                node[p] = AttrDict()
            node = node[p]
        node[parts[-1]] = _literal(value)
    return config


def process_serving_config(config: AttrDict) -> AttrDict:
    """Eagerly validate the ``Serving`` block: the SLO block, the trace
    ring sizes, the admission-queue bound and the router block fail at
    launch instead of at first use."""
    serving = config.get("Serving")
    if not serving:
        return config
    from fleetx_tpu_torch.observability.slo import validate_slo_block

    validate_slo_block(serving.get("slo"))
    for key in ("trace_requests", "trace_events"):
        v = serving.get(key)
        if v is not None and int(v) <= 0:
            raise ValueError(f"Serving.{key} must be > 0, got {v!r}")
    mq = serving.get("max_queue")
    if mq is not None and int(mq) < 0:
        raise ValueError(
            f"Serving.max_queue must be >= 0 (0 = unbounded admission "
            f"queue), got {mq!r}")
    router = serving.get("router")
    if router is not None:
        if not isinstance(router, dict):
            raise ValueError(
                f"Serving.router must be a mapping of router knobs, "
                f"got {router!r}")
        from fleetx_tpu_torch.serving.router import RouterConfig

        try:
            RouterConfig.from_dict(dict(router))
        except (AssertionError, TypeError, ValueError) as e:
            raise ValueError(f"Serving.router invalid: {e}") from e
    return config


#: ``Distributed`` keys whose value above 1 would shard the run
DEGREE_KEYS = ("dp_degree", "mp_degree", "pp_degree", "fsdp_degree",
               "seq_degree")


#: modules of the dense GPT family, the one family the tensor- and
#: sequence-parallel step and ZeRO stage 3 cover
DENSE_GPT_MODULES = ("GPTModule", "GPTEvalModule", "GPTGenerationModule")


def _item12(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, port queue item 12)")


def check_covered(config: dict) -> None:
    """Raise on a resolved ``Distributed`` layout the sharded training
    step does not cover: a pipeline, the ring over more than one ``seq``
    rank, MoE over more than one rank, and tensor or sequence parallelism
    or ZeRO stage 3 for a family other than the dense GPT."""
    dist = config.get("Distributed") or {}
    model = config.get("Model") or {}
    pp, seq = int(dist.get("pp_degree") or 1), int(dist.get("seq_degree")
                                                    or 1)
    mp = int(dist.get("mp_degree") or 1)
    fsdp = int(dist.get("fsdp_degree") or 1)
    stage = int((dist.get("sharding") or {}).get("sharding_stage") or 0)
    if pp > 1:
        raise _item12(f"Distributed.pp_degree={pp} (the pipeline)")
    if seq > 1:
        raise _item12(f"Distributed.seq_degree={seq} (the ring over seq "
                      f"ranks)")
    world = int(dist.get("dp_degree") or 1) * fsdp * mp
    if int(model.get("moe_num_experts") or 0) > 0 and world > 1:
        raise _item12(f"MoE over {world} ranks (expert parallel over "
                      f"tensor)")
    module = model.get("module", "GPTModule")
    if module not in DENSE_GPT_MODULES:
        if mp > 1:
            raise _item12(f"tensor parallel (mp_degree={mp}) for {module}")
        if stage >= 3 and fsdp > 1:
            raise _item12(f"ZeRO stage 3 for {module}")


def process_dist_config(config: AttrDict,
                        num_devices: Optional[int] = None) -> AttrDict:
    """Validate and derive the mesh degrees (``process_dist_config``).

    JAX's math against ``num_devices`` (the world size; 1 when not
    given): an unset ``dp_degree`` (None or -1) is derived so that the
    product of the degrees equals the count, and a product that does not
    match raises JAX's message.
    """
    if num_devices is None:
        num_devices = 1
    dist = config.setdefault("Distributed", AttrDict())
    degrees = {
        "pp_degree": int(dist.get("pp_degree") or 1),
        "fsdp_degree": int(dist.get("fsdp_degree") or (
            dist.get("sharding") or {}).get("sharding_degree") or 1),
        "seq_degree": int(dist.get("seq_degree") or 1),
        "mp_degree": int(dist.get("mp_degree") or 1),
    }
    fixed = (degrees["pp_degree"] * degrees["fsdp_degree"]
             * degrees["seq_degree"] * degrees["mp_degree"])
    dp = dist.get("dp_degree")
    if dp in (None, -1):
        if num_devices % fixed:
            raise ValueError(f"device count {num_devices} not divisible by "
                             f"pp*fsdp*seq*mp={fixed}")
        dp = num_devices // fixed
    dp = int(dp)
    if dp * fixed != num_devices:
        raise ValueError(f"dp({dp}) * pp*fsdp*seq*mp({fixed}) != device "
                         f"count ({num_devices})")
    dist.dp_degree = dp
    for k, v in degrees.items():
        dist[k] = v
    sharding = dist.setdefault("sharding", AttrDict())
    sharding.setdefault("sharding_degree", degrees["fsdp_degree"])
    sharding.setdefault("sharding_stage",
                        1 if degrees["fsdp_degree"] > 1 else 0)
    sharding.setdefault("sharding_offload", False)
    sharding.setdefault("overlap_update", False)
    return config


def process_global_configs(config: AttrDict) -> AttrDict:
    """Resolve global/local/micro batch relations (``config.py:68-117``)::

        global = local * dp_world ;  accumulate_steps = local // micro
    """
    glb = config.setdefault("Global", AttrDict())
    dist = config.get("Distributed", AttrDict())
    dp_world = int(dist.get("dp_degree", 1)) * int(dist.get("fsdp_degree", 1))
    gbs = glb.get("global_batch_size")
    lbs = glb.get("local_batch_size")
    mbs = glb.get("micro_batch_size")
    if gbs is None and lbs is None:
        raise ValueError("global_batch_size or local_batch_size must be set")
    if lbs is None:
        if gbs % dp_world:
            raise ValueError(f"global_batch_size {gbs} not divisible by dp "
                             f"world {dp_world}")
        lbs = gbs // dp_world
    if gbs is None:
        gbs = lbs * dp_world
    if mbs is None:
        mbs = lbs
    if lbs % mbs:
        raise ValueError(f"local_batch_size {lbs} % micro_batch_size {mbs} "
                         f"!= 0")
    if gbs != lbs * dp_world:
        raise ValueError(f"global_batch_size {gbs} != local_batch_size {lbs} "
                         f"* dp world {dp_world}")
    glb.global_batch_size = int(gbs)
    glb.local_batch_size = int(lbs)
    glb.micro_batch_size = int(mbs)
    glb.setdefault("seed", 1024)
    eng = config.setdefault("Engine", AttrDict())
    if eng.get("accumulate_steps") in (None, 0):
        eng.accumulate_steps = glb.local_batch_size // glb.micro_batch_size
    return config


def process_engine_config(config: AttrDict) -> AttrDict:
    """Fill Engine defaults (``process_engine_config``)."""
    eng = config.setdefault("Engine", AttrDict())
    eng.setdefault("run_mode", "step")
    eng.setdefault("num_train_epochs", 1)
    eng.setdefault("max_steps", 500000)
    eng.setdefault("logging_freq", 10)
    eng.setdefault("eval_freq", None)
    eng.setdefault("eval_iters", 10)
    mp = eng.setdefault("mix_precision", AttrDict())
    mp.setdefault("enable", True)
    mp.setdefault("dtype", "bfloat16")
    mp.setdefault("param_dtype", "float32")
    mp.setdefault("scale_loss", None)
    sl = eng.setdefault("save_load", AttrDict())
    sl.setdefault("save_steps", None)
    sl.setdefault("save_epoch", 1)
    sl.setdefault("output_dir", "./output")
    sl.setdefault("ckpt_dir", None)
    return config


def process_observability_config(config: AttrDict) -> AttrDict:
    """Ensure the ``Observability`` block exists with ``enable`` and
    ``gang`` (both default False: telemetry never surprises a recipe);
    per-knob defaults live in ``observability.Observability``. A flight
    ring or a gap report sized zero would record nothing, found out only
    when it is read, so both are validated here."""
    obs = config.setdefault("Observability", AttrDict())
    obs.setdefault("enable", False)
    obs.setdefault("gang", False)
    capacity = (obs.get("flight") or {}).get("capacity")
    if capacity is not None and int(capacity) <= 0:
        raise ValueError(
            f"Observability.flight.capacity must be > 0, got {capacity!r}")
    top_k = (obs.get("perf") or {}).get("top_k")
    if top_k is not None and int(top_k) <= 0:
        raise ValueError(
            f"Observability.perf.top_k must be > 0, got {top_k!r}")
    return config


def process_resilience_config(config: AttrDict) -> AttrDict:
    """Ensure the ``Resilience`` block exists with ``enable`` (default
    False: fault handling never changes a recipe's behaviour silently);
    per-knob defaults live in ``resilience.Resilience``. The knobs whose
    typo would surface only mid-run are validated here."""
    res = config.setdefault("Resilience", AttrDict())
    res.setdefault("enable", False)

    def _positive(block: str, key: str, value) -> None:
        if value is not None and float(value) <= 0:
            raise ValueError(
                f"Resilience.{block}.{key} must be > 0, got {value!r}")

    coord = res.get("coordination") or {}
    _positive("coordination", "timeout_s", coord.get("timeout_s"))
    _positive("coordination", "poll_s", coord.get("poll_s"))
    pre = res.get("preemption") or {}
    _positive("preemption", "sync_every", pre.get("sync_every"))
    wd = res.get("watchdog") or {}
    _positive("watchdog", "gang_timeout_s", wd.get("gang_timeout_s"))
    gang_steps = wd.get("gang_sync_steps")
    if gang_steps is not None and int(gang_steps) < 0:
        raise ValueError(
            f"Resilience.watchdog.gang_sync_steps must be >= 0 "
            f"(0 disables the gang barrier), got {gang_steps!r}")
    integ = res.get("integrity") or {}
    sentinel = integ.get("sentinel_every")
    if sentinel is not None and int(sentinel) < 0:
        raise ValueError(
            f"Resilience.integrity.sentinel_every must be >= 0 "
            f"(0 disables the SDC sentinel), got {sentinel!r}")
    action = integ.get("sentinel_action")
    if action is not None and action not in ("log", "quarantine", "abort"):
        raise ValueError(
            f"Resilience.integrity.sentinel_action must be log | "
            f"quarantine | abort, got {action!r}")
    verify = integ.get("verify_checkpoints")
    if verify is not None and not isinstance(verify, bool):
        raise ValueError(
            f"Resilience.integrity.verify_checkpoints must be a bool, "
            f"got {verify!r}")
    return config


#: the dynamic loss scaler's initial scale when ``scale_loss`` is unset
DEFAULT_LOSS_SCALE = 32768.0


def loss_scaler(config: dict) -> Optional[float]:
    """The fp16 dynamic loss scaler's initial scale, or None when the
    scaler is off. It is on only when ``Engine.mix_precision.use_pure_fp16``
    is set AND ``Model.dtype`` is float16: float16 without
    ``use_pure_fp16`` trains fp16 with no scaler, and ``use_pure_fp16``
    with another dtype is a no-op, as in the JAX engine."""
    mp = dict((config.get("Engine") or {}).get("mix_precision") or {})
    dtype = str((config.get("Model") or {}).get("dtype") or "")
    if not mp.get("use_pure_fp16") or dtype != "float16":
        return None
    return float(mp.get("scale_loss") or DEFAULT_LOSS_SCALE)


#: the JAX loader's planner budget where the YAML names none (a TPU
#: figure; the port uses it only on the CPU)
DEFAULT_HBM_GB = 16.0


def layout_budget_gb(auto_layout: Any, device=None) -> tuple:
    """``(hbm_gb, source)``: the planner's budget from
    ``Distributed.auto_layout``'s ``hbm_gb``; else the memory of the card
    ``device`` names (None is cuda, which raises without a GPU); else, on
    the CPU, ``DEFAULT_HBM_GB``."""
    if isinstance(auto_layout, dict) and \
            auto_layout.get("hbm_gb") is not None:
        return float(auto_layout["hbm_gb"]), "Distributed.auto_layout.hbm_gb"
    import torch

    from fleetx_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return props.total_memory / 2 ** 30, f"the memory of {props.name}"
    return DEFAULT_HBM_GB, "the JAX loader's default, on the CPU"


def plan_layout(config: AttrDict, device=None,
                num_devices: Optional[int] = None) -> AttrDict:
    """The planner step of ``get_config`` for ``num_devices`` (1 when not
    given): explicit degrees are kept (and checked later in
    ``process_dist_config``); otherwise ``suggest_layout``'s degrees are
    merged into ``Distributed``. Pops ``Distributed.auto_layout``."""
    from fleetx_tpu_torch.parallel.auto_layout import (
        advice_inputs, suggest_layout)
    from fleetx_tpu_torch.utils.log import logger

    num_devices = int(num_devices or 1)
    dist = config.get("Distributed") or {}
    hbm_gb, source = layout_budget_gb(dist.get("auto_layout"), device)
    explicit = {k for k in DEGREE_KEYS if int(dist.get(k) or 0) > 1}
    if int((dist.get("sharding") or {}).get("sharding_degree") or 0) > 1:
        explicit.add("sharding.sharding_degree")
    logger.info("auto_layout: %d device%s, budget %.2f GB (%s)",
                num_devices, "" if num_devices == 1 else "s", hbm_gb, source)
    if explicit:
        logger.info("auto_layout: explicit degrees %s kept", explicit)
    else:
        mdl, mb, gran = advice_inputs(config, data_world=num_devices)
        layout = suggest_layout(mdl, num_devices, hbm_gb=hbm_gb,
                                micro_batch=mb, recompute=gran)
        config.setdefault("Distributed", AttrDict())
        for k, v in layout.items():
            if k == "sharding" and isinstance(
                    config["Distributed"].get("sharding"), dict):
                config["Distributed"]["sharding"].update(v)
            else:
                config["Distributed"][k] = v
    config["Distributed"].pop("auto_layout", None)
    return config


def get_config(fname: str, overrides: Optional[list] = None,
               auto_layout: bool = False, device=None,
               num_devices: Optional[int] = None,
               training: bool = False) -> AttrDict:
    """Load + override + post-process a config (``get_config``); with
    ``auto_layout`` or ``Distributed.auto_layout`` the layout planner runs
    first (``plan_layout``; ``device`` sizes its budget). ``num_devices``
    (the world of the entry point; 1 when not given) is what the degrees
    are checked against (``process_dist_config``). ``training`` (the
    training loader) refuses a layout the sharded training step does not
    cover (``check_covered``), ahead of a world mismatch."""
    if not os.path.exists(fname):
        raise FileNotFoundError(f"config file {fname} not found")
    config = parse_config(fname)
    override_config(config, overrides)
    if auto_layout or (config.get("Distributed") or {}).get("auto_layout"):
        plan_layout(config, device, num_devices)
    if training:
        check_covered(config)
    process_dist_config(config, num_devices)
    if training:
        check_covered(config)
    process_global_configs(config)
    process_engine_config(config)
    process_observability_config(config)
    process_resilience_config(config)
    process_serving_config(config)
    return config


def parse_args(description: str = "fleetx_tpu_torch",
               argv: Optional[list] = None) -> argparse.Namespace:
    """``-c config.yaml -o A.B=v [--device cuda|cpu]`` (``parse_args``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-c", "--config", required=True,
                        help="path to YAML config")
    parser.add_argument("-o", "--override", action="append", default=[],
                        help="dotted config overrides, e.g. "
                             "-o Engine.max_steps=10")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)
