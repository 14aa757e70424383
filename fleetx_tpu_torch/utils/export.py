"""Model export: ``torch.export`` programs with their parameters (port of
``fleetx_tpu/utils/export.py:54-123``).

The JAX artifact is a serialized ``jax.export`` module (StableHLO) plus
the parameter pytree. Here it is::

    {out_dir}/program.pt2  — the exported programs (``torch.export``'s
                             pt2 archive: one program, ``model``, for
                             the forward target; ``prefill`` and
                             ``decode`` for generation)
    {out_dir}/params.npz   — flat parameter arrays keyed by tree path
                             (``gpt/embeddings/word_embeddings``, the
                             JAX ``_path_key`` encoding)
    {out_dir}/meta.json    — each program's input signature, the device
                             type and model dtype it was exported for, the
                             param dtypes, the param specs when given and
                             the caller's extra keys

Each program is ``fn(params, *inputs)`` with the parameters as inputs, as
in JAX, so the weights live in ``params.npz`` once. The two artifacts are
not interchangeable: a ``.pt2`` program runs under PyTorch, on the device
type it was exported for (the program's own tensors, a cache or an
``arange``, are made there); ``load_exported`` on another device type
raises. The programs record the port's kernels as the custom ops
``torch.ops.fleetx_tpu_torch.flash_fwd`` / ``fused_norm_fwd``, so the
loader imports ``fleetx_tpu_torch.ops`` before it loads them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.core.checkpoint import (_to_host, _to_torch, flatten,
                                              unflatten)
from fleetx_tpu_torch.utils.log import logger

PROGRAM_NAME = "program.pt2"
PARAMS_NAME = "params.npz"
META_NAME = "meta.json"


class _Program(torch.nn.Module):
    """``fn`` as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, params, *inputs):
        return self.fn(params, *inputs)


def _signature(args) -> list:
    return [{"shape": list(a.shape), "dtype": str(a.dtype).replace(
        "torch.", "")} for a in args]


def _encode_spec(spec: Any) -> list:
    """A spec of LOGICAL axis names → JSON (``[axis | [axes...] | null]``)."""
    return [None if e is None else list(e) if isinstance(e, (tuple, list))
            else str(e) for e in tuple(spec)]


def export_model(fn: Union[Callable, dict], example_args: Union[tuple, dict],
                 out_dir: str, params: dict, param_specs: Any = None,
                 meta: Optional[dict] = None) -> dict:
    """Export ``fn(params, *inputs)`` and save it with its parameters.

    ``fn`` is one callable (saved as the program ``model``) or a dict
    name → callable, with ``example_args`` the matching tuple or dict of
    tuples of example inputs (their shapes and dtypes are the programs'
    signature; the programs run on the device they lie on).
    ``param_specs``: an optional tree of logical-axis specs shaped like
    ``params``, kept in ``meta.json``. ``meta`` adds keys to
    ``meta.json``. Returns the meta written."""
    from torch.export.pt2_archive._package import package_pt2

    fns = fn if isinstance(fn, dict) else {"model": fn}
    args = example_args if isinstance(example_args, dict) \
        else {"model": tuple(example_args)}
    if set(fns) != set(args):
        raise ValueError(f"programs {sorted(fns)} and example inputs "
                         f"{sorted(args)} differ")
    flat = {k: v.detach() for k, v in flatten(params).items()}
    params = unflatten(flat)
    devices = {v.device.type for v in flat.values()}
    if len(devices) != 1:
        raise ValueError(f"parameters on several device types: {devices}")
    os.makedirs(out_dir, exist_ok=True)
    programs = {name: torch.export.export(
        _Program(f), (params,) + tuple(args[name])) for name, f in fns.items()}
    for ep in programs.values():
        # the archive would keep the example inputs, the weights included
        ep.example_inputs = None
    package_pt2(os.path.join(out_dir, PROGRAM_NAME),
                exported_programs=programs)
    arrays, dtypes = {}, {}
    for key, leaf in flat.items():
        arrays[key], dtypes[key] = _to_host(leaf)
    np.savez(os.path.join(out_dir, PARAMS_NAME), **arrays)
    record = dict(meta or {})
    record.update(
        programs=sorted(programs),
        inputs={name: _signature(a) for name, a in args.items()},
        device=devices.pop(), param_dtypes=dtypes,
        torch=torch.__version__)
    if param_specs is not None:
        record["param_specs"] = {k: _encode_spec(v) for k, v in flatten(
            param_specs).items()}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(record, f, indent=2)
    logger.info("exported %s to %s (device %s)", sorted(programs), out_dir,
                record["device"])
    return record


def read_meta(out_dir: str) -> dict:
    """The artifact's ``meta.json``."""
    with open(os.path.join(out_dir, META_NAME)) as f:
        return json.load(f)


def load_exported(out_dir: str,
                  device: Union[str, torch.device, None] = None) -> tuple:
    """``(programs, params)``: name → callable ``program(params,
    *inputs)`` and the parameter tree on ``device`` (default: the device
    type the artifact was exported for). Another device type raises."""
    from torch.export.pt2_archive._package import load_pt2

    # the programs name the port's custom ops: register them first
    import fleetx_tpu_torch.ops.flash_attention  # noqa: F401
    import fleetx_tpu_torch.ops.fused_norm  # noqa: F401

    meta = read_meta(out_dir)
    device = torch.device(device if device is not None else meta["device"])
    if device.type != meta["device"]:
        raise ValueError(
            f"{out_dir} was exported for {meta['device']} and cannot run on "
            f"{device.type}: a program makes its own tensors on the device "
            f"it was traced on; export it again with --device "
            f"{device.type}")
    contents = load_pt2(os.path.join(out_dir, PROGRAM_NAME))
    programs = {name: ep.module()
                for name, ep in contents.exported_programs.items()}
    arrays = np.load(os.path.join(out_dir, PARAMS_NAME))
    params = unflatten({k: _to_torch(arrays[k], meta["param_dtypes"][k]).to(
        device) for k in arrays.files})
    return programs, params


def load_param_specs(out_dir: str) -> Any:
    """The export's saved logical-axis spec tree (shaped like the params,
    each spec a tuple), or None when the export has none."""
    meta = read_meta(out_dir)
    if "param_specs" not in meta:
        return None
    return unflatten({k: tuple(tuple(e) if isinstance(e, list) else e
                               for e in v)
                      for k, v in meta["param_specs"].items()})
