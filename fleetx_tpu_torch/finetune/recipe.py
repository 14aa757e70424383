"""Fine-tune orchestration: pretrain checkpoint → LoRA fit → adapter
artifact (port of ``fleetx_tpu/finetune/recipe.py``).

The engine needs no new hooks; the recipe composes existing pieces in a
fixed order:

1. ``engine.prepare`` makes the state (seeded base + injected adapters,
   ``LoRAGPTModule.init_params``; or, with ``ckpt_dir`` set, a fine-tune
   checkpoint's state restored over it);
2. the pretrain checkpoint's params, verified by
   ``core/checkpoint.load_params``, are copied over the base leaves
   (``graft_base_params``; the adapters keep their values, so a fresh run
   starts at the restored base since B is zeros);
3. ``engine.fit`` runs the ordinary loop; the masked optimizer
   (``lora.lora_optimizer``) never writes a base leaf;
4. the frozen-base audit re-digests every base leaf after the fit and
   refuses to publish on any drift, naming the leaf;
5. ``save_adapter`` publishes the adapter-only artifact, stamped with the
   audited base digests.

Grafting the same base again is a no-op on the values, so a run resumed
from its own fine-tune checkpoint re-grafts safely.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import torch

from fleetx_tpu_torch.core import checkpoint as ckpt_lib
from fleetx_tpu_torch.finetune import checkpoint as ft_ckpt
from fleetx_tpu_torch.finetune import lora
from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.utils.log import logger

__all__ = ["graft_base_params", "prepare_finetune", "assert_base_frozen",
           "finetune"]


def graft_base_params(engine: Any, base_params: dict) -> None:
    """Copy restored pretrain values into the engine's base leaves, in
    place, keeping the adapter leaves. Every leaf is checked before any is
    written: a checkpoint leaf the model lacks, a base leaf the checkpoint
    lacks, or a shape / dtype that differs raises ``ValueError`` naming
    the leaf."""
    flat_base = ckpt_lib.flatten(base_params)
    state = {name: leaf for name, leaf in
             ckpt_lib.flatten(engine.params).items()
             if not lora.is_adapter_name(name)}
    for name, leaf in state.items():
        got = flat_base.get(name)
        if got is None:
            continue
        if tuple(got.shape) != tuple(leaf.shape) or got.dtype != leaf.dtype:
            raise ValueError(
                f"base checkpoint leaf {name!r} is "
                f"{tuple(got.shape)}/{got.dtype} but the fine-tune model "
                f"expects {tuple(leaf.shape)}/{leaf.dtype} — the FineTune "
                f"Model section does not match the pretrain architecture")
    extra = sorted(set(flat_base) - set(state))
    if extra:
        raise ValueError(
            f"base checkpoint carries leaf {extra[0]!r} the fine-tune "
            f"state lacks ({len(extra)} unmatched) — wrong module or "
            f"architecture for this checkpoint")
    absent = sorted(set(state) - set(flat_base))
    if absent:
        # a base leaf the checkpoint does not carry would keep its random
        # init, and the run would fine-tune (and stamp digests) against a
        # partially random base
        raise ValueError(
            f"fine-tune base leaf {absent[0]!r} is absent from the "
            f"pretrain checkpoint ({len(absent)} ungrafted) — refusing to "
            f"train against a partially random base")
    with torch.no_grad():
        for name, leaf in state.items():
            leaf.copy_(flat_base[name])
    logger.info("grafted %d base leaves from the pretrain checkpoint",
                len(state))


def prepare_finetune(engine: Any, base_dir: Optional[str]) -> None:
    """The fine-tune state: engine prepare, the verified base restore and
    graft, and the ``trainable_params_frac`` gauge (the optimizer's own
    mask, ``lora.adapter_mask``)."""
    engine.prepare()
    if base_dir:
        graft_base_params(engine, ckpt_lib.load_params(
            str(base_dir), device=engine.device))
    frac = lora.trainable_params_frac(engine.params)
    get_registry().gauge("trainable_params_frac").set(frac)
    logger.info("trainable_params_frac: %.5f", frac)


def assert_base_frozen(before: dict, after: dict) -> None:
    """Refuse, naming the leaf, unless every base digest is unchanged."""
    for name in sorted(before):
        b, a = before[name], after.get(name)
        if a is None or int(a["crc32"]) != int(b["crc32"]) or \
                int(a["nbytes"]) != int(b["nbytes"]):
            raise RuntimeError(
                f"frozen-base violation: leaf {name!r} changed during "
                f"fine-tuning — the optimizer mask did not hold; not "
                f"publishing an adapter trained off its declared base")


def finetune(engine: Any, train_dl: Iterable, valid_dl: Iterable = None,
             *, base_dir: Optional[str], adapter_dir: str,
             on_prepared: Optional[Callable[[Any], None]] = None) -> tuple:
    """The whole recipe; returns ``(logged losses, artifact path)``.
    ``on_prepared(engine)``, when given, runs once the state is grafted,
    just before the fit (the CLI zeroes its launch counts and keeps the
    adapters' starting values there)."""
    prepare_finetune(engine, base_dir)
    if on_prepared is not None:
        on_prepared(engine)
    before = lora.base_leaf_digests(engine.params)
    losses = engine.fit(train_dl, valid_dl)
    after = lora.base_leaf_digests(engine.params)
    assert_base_frozen(before, after)
    module = engine.module
    # the audit just proved `after` describes the base bit for bit: the
    # stamp reuses it instead of digesting the whole base a third time
    path = ft_ckpt.save_adapter(
        adapter_dir, engine.step, engine.params, base_dir=base_dir,
        rank=module.lora_rank, alpha=module.lora_alpha,
        base_digests=after)
    return losses, path
