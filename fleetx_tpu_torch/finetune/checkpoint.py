"""Adapter-only checkpoint artifact (port of
``fleetx_tpu/finetune/checkpoint.py``).

A fine-tune run's durable product is the adapter leaves plus the
provenance that proves what they belong to. The artifact is a
``step_<N>`` directory in the port's checkpoint idiom
(``core/checkpoint.py``): ``state.npz`` (leaf ``i`` under ``leaf_<i>``,
``__names__`` / ``__dtypes__``, bf16 as its raw bits), the
``fleetx_integrity.json`` manifest, then the ``fleetx_meta.json``
completion marker, each written atomically in that order, so
``tools.verify_ckpt`` audits it unmodified and either package's loader
reads the other's artifact.

The meta stamps three identities, and a restore refuses loudly when one
has drifted (``AdapterDriftError`` naming the leaf or the stamp):

- ``base_leaves``: per-leaf digests of the frozen base the adapters were
  trained against (name → crc32 / nbytes);
- ``spec_registry``: the fingerprint of the JAX package's ``gpt_lora``
  partition-rule family. The port has no rule registry, so it keeps that
  fingerprint's value as ``GPT_LORA_FINGERPRINT`` (a test holds it to the
  JAX ``family_fingerprint("gpt_lora")``), stamps it, and refuses any
  other;
- ``base_ckpt``: the pretrain directory, for operators (the digests are
  the authority).

The payload is verified as in ``core/checkpoint.py``: the file digests
before any byte is decoded, each leaf after.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from fleetx_tpu_torch.core import checkpoint as ckpt_lib
from fleetx_tpu_torch.finetune import lora
from fleetx_tpu_torch.resilience import integrity
from fleetx_tpu_torch.resilience.integrity import CheckpointIntegrityError
from fleetx_tpu_torch.utils.log import logger

__all__ = ["AdapterDriftError", "ADAPTER_ARTIFACT", "GPT_LORA_FAMILY",
           "GPT_LORA_FINGERPRINT", "save_adapter", "load_adapter",
           "apply_adapter_checkpoint", "adapter_bytes"]

#: meta marker distinguishing adapter artifacts from full checkpoints
ADAPTER_ARTIFACT = "lora_adapter"

#: the JAX package's partition-rule family of an adapted GPT tree
GPT_LORA_FAMILY = "gpt_lora"

#: ``fleetx_tpu.parallel.rules.family_fingerprint("gpt_lora")``: the rule
#: table that defines the adapter naming contract
GPT_LORA_FINGERPRINT = "ad76ee412abbdb9e"


class AdapterDriftError(RuntimeError):
    """An adapter artifact was offered a base (or rule table) it was not
    trained against. Never merged anyway: re-point the base or re-train
    the adapter."""


def save_adapter(directory: str, step: int, params: dict, *,
                 base_dir: Optional[str], rank: int, alpha: float,
                 base_digests: Optional[dict] = None) -> str:
    """Publish one adapter-only artifact for ``step`` under ``directory``;
    returns its step directory.

    ``params`` is the full fine-tune tree; only the adapter leaves are
    written, the base contributes its per-leaf digests (pass
    ``base_digests`` when the caller holds them already). Payload, then
    manifest, then meta, each atomic: a directory with a meta is always a
    fully described artifact."""
    path = os.path.abspath(ckpt_lib.step_dir(directory, step))
    os.makedirs(path, exist_ok=True)
    base_tree, adapters = lora.split_adapters(params)
    assert adapters, "params carry no adapter leaves — nothing to save"
    names = sorted(adapters)
    host = [ckpt_lib._to_host(adapters[n]) for n in names]
    arrays = {f"leaf_{i}": arr for i, (arr, _) in enumerate(host)}
    arrays["__names__"] = np.array(names, dtype=str)
    arrays["__dtypes__"] = np.array([d for _, d in host], dtype=str)
    integrity.atomic_write(os.path.join(path, ckpt_lib.STATE_NAME),
                           lambda f: np.savez(f, **arrays), mode="wb")
    integrity.write_manifest(path, leaves=[integrity.digest_array(arr)
                                           for arr, _ in host])
    meta = {
        "step": int(step),
        "artifact": ADAPTER_ARTIFACT,
        "spec_family": GPT_LORA_FAMILY,
        "spec_registry": GPT_LORA_FINGERPRINT,
        "base_ckpt": os.path.abspath(base_dir) if base_dir else None,
        "lora": {"rank": int(rank), "alpha": float(alpha), "names": names},
        "base_leaves": dict(base_digests) if base_digests is not None
        else lora.base_leaf_digests(base_tree),
    }
    integrity.atomic_write(os.path.join(path, ckpt_lib.META_NAME),
                           lambda f: json.dump(meta, f))
    logger.info("saved adapter artifact: %s (%d leaves, %d bytes)", path,
                len(names), adapter_bytes(path))
    return path


def adapter_bytes(path: str) -> int:
    """On-disk payload bytes of one adapter step directory."""
    target = os.path.join(path, ckpt_lib.STATE_NAME)
    return os.path.getsize(target) if os.path.exists(target) else 0


def _read_meta(path: str) -> dict:
    """The artifact's meta; unreadable, or not an adapter's, refuses."""
    target = os.path.join(path, ckpt_lib.META_NAME)
    try:
        with open(target) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"adapter meta {target} unreadable ({e}) — refusing to merge "
            f"an adapter without provenance") from e
    if not isinstance(meta, dict) or \
            meta.get("artifact") != ADAPTER_ARTIFACT:
        raise AdapterDriftError(
            f"{path} is not an adapter artifact (artifact="
            f"{meta.get('artifact') if isinstance(meta, dict) else None!r})"
            f" — point adapter_dir at a save_adapter directory")
    return meta


def _check_registry(meta: dict, path: str) -> None:
    """Refuse an artifact stamped under another rule table (or another
    family) than the one the port's adapter naming follows."""
    family = meta.get("spec_family") or GPT_LORA_FAMILY
    stamped = meta.get("spec_registry")
    if family != GPT_LORA_FAMILY or stamped != GPT_LORA_FINGERPRINT:
        raise AdapterDriftError(
            f"adapter {path} was saved under {family!r} rule table "
            f"{stamped} but the port's adapters follow {GPT_LORA_FAMILY!r} "
            f"table {GPT_LORA_FINGERPRINT} — the rules have changed since "
            f"training; refusing to merge")


def _check_base(meta: dict, base_params: dict, path: str) -> None:
    """Refuse on base drift, naming the first mismatching leaf."""
    want = dict(meta.get("base_leaves") or {})
    got = lora.base_leaf_digests(base_params)
    missing = sorted(set(want) - set(got))
    if missing:
        raise AdapterDriftError(
            f"adapter {path} expects base leaf {missing[0]!r} which the "
            f"offered base tree lacks ({len(missing)} missing leaves) — "
            f"wrong or restructured base checkpoint")
    extra = sorted(set(got) - set(want))
    if extra:
        raise AdapterDriftError(
            f"offered base tree carries leaf {extra[0]!r} the adapter "
            f"{path} was not trained against ({len(extra)} extra leaves)")
    for name in sorted(want):
        w, g = want[name], got[name]
        if int(w["crc32"]) != int(g["crc32"]) or \
                int(w["nbytes"]) != int(g["nbytes"]):
            raise AdapterDriftError(
                f"base leaf {name!r} has drifted from the weights adapter "
                f"{path} was trained against (crc {int(g['crc32']):#010x} "
                f"!= stamped {int(w['crc32']):#010x}) — refusing to merge "
                f"onto the wrong base")


def load_adapter(directory: str, step: Optional[int] = None, *,
                 base_params: Optional[dict] = None) -> tuple:
    """``(adapters_by_name as CPU tensors, meta)`` of one adapter
    artifact (the newest completed step unless ``step`` is given), fully
    verified: manifest file digests → rule-table stamp → base digests
    (when ``base_params`` is offered) → leaf digests. A failure raises
    ``AdapterDriftError`` or ``CheckpointIntegrityError``."""
    directory = os.path.abspath(directory)
    step = step if step is not None else ckpt_lib.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no adapter artifact under {directory}")
    path = ckpt_lib.step_dir(directory, step)
    meta = _read_meta(path)
    manifest = integrity.read_manifest(path)
    if manifest is None:
        raise CheckpointIntegrityError(
            f"adapter {path} carries no integrity manifest — adapter "
            f"artifacts are always manifested; refusing to merge "
            f"unverifiable bytes")
    bad = integrity.verify_files(path, manifest)
    if bad:
        raise CheckpointIntegrityError(
            f"adapter {path} failed integrity verification: files {bad} "
            f"do not match the manifest digests")
    _check_registry(meta, path)
    if base_params is not None:
        _check_base(meta, base_params, path)
    adapters = ckpt_lib._read_state(path, manifest)
    logger.info("loaded adapter artifact %s (step %d, %d leaves%s)", path,
                int(step), len(adapters),
                ", base verified" if base_params is not None else "")
    return adapters, meta


def apply_adapter_checkpoint(base_params: dict, directory: str,
                             step: Optional[int] = None) -> dict:
    """Base params + adapter artifact → merged serving weights: verifies
    the artifact and the offered base against the stamped digests, puts
    the adapters on the base's device in the dtype they were saved in,
    and folds them into the kernels (the result has the base model's
    structure)."""
    adapters, meta = load_adapter(directory, step, base_params=base_params)
    device = next(iter(ckpt_lib.flatten(base_params).values())).device
    combined = lora.combine_adapters(
        base_params, {k: v.to(device) for k, v in adapters.items()})
    with torch.no_grad():
        return lora.merge_adapters(combined,
                                   alpha=float(meta["lora"]["alpha"]))
