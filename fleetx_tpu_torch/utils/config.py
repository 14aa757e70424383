"""YAML config loading with ``_base_`` inheritance and dotted overrides.

The port's copy of ``fleetx_tpu/utils/config.py:38-135`` (``AttrDict``,
``_merge``, ``parse_config``, ``_literal``, ``override_config``) and
``:334-376`` (``process_serving_config``). It reads the same YAML files
by path. The mesh-degree and batch derivations of the training recipes
are not part of the serving slice and are not copied.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

import yaml

__all__ = ["AttrDict", "parse_config", "override_config",
           "process_serving_config"]


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
