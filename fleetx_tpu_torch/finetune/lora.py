"""LoRA adapter algebra: injection, masking, merge (port of
``fleetx_tpu/finetune/lora.py``).

For a target kernel ``W`` with input features ``in`` and output features
``out`` the adapter pair is ``A`` (``<kernel>_lora_a``, ``[*stack, *in,
r]``, normal init with std 0.02) and ``B`` (``<kernel>_lora_b``,
``[*stack, r, *out]``, zeros), and the effective kernel is ``W + (alpha /
r) · A @ B``: zero delta at step 0, so fine-tuning starts at the base
model. The adapters are siblings of their kernel in the port's nested
parameter dict, so the stacked ``[layers, ...]`` kernels get stacked
adapters and the fold is one batched matmul over the layer dim. The
model code is untouched: ``merge_adapters`` folds the delta into the
kernels before the forward, and autograd carries the gradients to ``A``
and ``B`` through the fold.

``A``'s values come from one ``torch.Generator``, target by target in
tree order; they have the JAX init's distribution, not its bits
(``jax.random`` and torch's generators never agree), so tests that
compare the two sides carry one side's adapters across
(``convert.params_from_jax``).

The optimizer side: ``lora_optimizer(inner)`` runs the inner ``AdamW`` on
the adapter leaves alone (its moments exist only for them) and leaves
every base leaf untouched. The clip's norm is that of ALL grads, base
included, as in the JAX engine: its ``optax.global_norm`` over the whole
grad tree reaches ``clip_by_precomputed_norm`` through ``optax.masked``,
which forwards the extra argument unmasked. The registry's sharding
metadata (``adapter_axis_names``, the flax boxing) has no counterpart on
one device.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from fleetx_tpu_torch.core import checkpoint as ckpt_lib
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.resilience import integrity

__all__ = [
    "LORA_TARGETS", "ADAPTER_SUFFIXES", "is_adapter_name", "target_of",
    "adapter_shapes", "inject_adapters", "adapter_delta", "merge_adapters",
    "split_adapters", "combine_adapters", "adapter_mask", "lora_optimizer",
    "LoRAOptimizer", "trainable_params_frac", "base_leaf_digests",
]

#: target matmuls → (feature_rank, n_in): how many trailing dims are the
#: kernel's feature axes, and how many of those are the matmul's input
#: side (the rest are output); leading dims beyond them are stack dims
LORA_TARGETS: dict = {
    "attn/qkv_kernel": (4, 1),   # [h | 3, nh, hd]
    "attn/out_kernel": (3, 2),   # [nh, hd | h]
    "mlp/wi_kernel": (2, 1),     # [h | m]
    "mlp/wo_kernel": (2, 1),     # [m | h]
}

#: the leaf-name suffixes every consumer (mask, codec) keys on
ADAPTER_SUFFIXES = ("_lora_a", "_lora_b")

#: init scale for A (B is zeros, so the starting delta is exactly 0)
_A_INIT_STDDEV = 0.02

#: stack dims a target may carry (the JAX registry's ``stage`` and
#: ``layers``)
_MAX_STACK = 2


def is_adapter_name(name: str) -> bool:
    """True when a slash-joined leaf path names an adapter leaf."""
    return name.endswith(ADAPTER_SUFFIXES)


def target_of(name: str, targets: Optional[dict] = None) -> Optional[str]:
    """The ``LORA_TARGETS`` key a slash-joined leaf path ends with (None
    when the leaf is not a target kernel)."""
    targets = targets or LORA_TARGETS
    return next((t for t in targets
                 if name == t or name.endswith("/" + t)), None)


def adapter_shapes(kernel_shape: tuple, rank: int, target: str,
                   targets: Optional[dict] = None) -> tuple:
    """``(A shape, B shape)`` of a target kernel's adapter pair: ``[*stack,
    *in, r]`` and ``[*stack, r, *out]``."""
    feature_rank, n_in = (targets or LORA_TARGETS)[target]
    shape = tuple(kernel_shape)
    n_stack = len(shape) - feature_rank
    assert 0 <= n_stack <= _MAX_STACK, (target, shape)
    stack = shape[:n_stack]
    in_dims = shape[n_stack:n_stack + n_in]
    out_dims = shape[n_stack + n_in:]
    return stack + in_dims + (int(rank),), stack + (int(rank),) + out_dims


def inject_adapters(params: dict, rank: int, seed: int = 0,
                    generator: Optional[torch.Generator] = None,
                    targets: Optional[dict] = None) -> dict:
    """A new tree with ``_lora_a`` / ``_lora_b`` siblings next to every
    target kernel (every other leaf is the same tensor). ``A`` draws from
    ``generator``, or from one seeded with ``seed`` on the first target's
    device; both adapters take the kernel's dtype and device."""
    targets = targets or LORA_TARGETS
    gen = [generator]

    def draw(shape: tuple, like: torch.Tensor) -> torch.Tensor:
        if gen[0] is None:
            gen[0] = torch.Generator(device=like.device)
            gen[0].manual_seed(int(seed))
        a = torch.empty(shape, dtype=like.dtype, device=like.device)
        return a.normal_(0.0, _A_INIT_STDDEV, generator=gen[0])

    def walk(node: dict, prefix: str) -> dict:
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value, f"{prefix}{key}/")
                continue
            out[key] = value
            hit = target_of(f"{prefix}{key}", targets)
            if hit is None:
                continue
            a_shape, b_shape = adapter_shapes(tuple(value.shape), rank, hit,
                                              targets)
            out[key + "_lora_a"] = draw(a_shape, value)
            out[key + "_lora_b"] = torch.zeros(b_shape, dtype=value.dtype,
                                               device=value.device)
        return out

    return walk(params, "")


def adapter_delta(a: torch.Tensor, b: torch.Tensor,
                  kernel_shape: tuple) -> torch.Tensor:
    """``A @ B`` reshaped to the target kernel's shape: ``a`` is ``[*stack,
    *in, r]``, ``b`` ``[*stack, r, *out]``; the feature dims flatten into
    one matmul per stack entry."""
    n_stack = a.dim() + b.dim() - len(kernel_shape) - 2
    assert n_stack >= 0, (a.shape, b.shape, kernel_shape)
    r = a.shape[-1]
    stack = tuple(a.shape[:n_stack])
    af = a.reshape(stack + (-1, r))
    bf = b.reshape(stack + (r, -1))
    return torch.matmul(af, bf).reshape(kernel_shape)


def merge_adapters(params: dict, alpha: float) -> dict:
    """Fold every adapter pair into its base kernel, ``W + (alpha/r)·A@B``
    in ``W``'s dtype; the result has the base model's structure (the
    adapter leaves are consumed, the other leaves are the same tensors).
    Differentiable: the fine-tune loss runs on it every step."""

    def walk(node: dict) -> dict:
        out = {}
        for key, value in node.items():
            if is_adapter_name(key):
                continue
            if isinstance(value, dict):
                out[key] = walk(value)
                continue
            a = node.get(key + "_lora_a")
            b = node.get(key + "_lora_b")
            if a is not None and b is not None:
                scale = torch.tensor(float(alpha) / int(a.shape[-1]),
                                     dtype=value.dtype, device=value.device)
                delta = adapter_delta(a, b, tuple(value.shape))
                out[key] = value + scale * delta.to(value.dtype)
            else:
                out[key] = value
        return out

    return walk(params)


def split_adapters(params: dict) -> tuple:
    """``(base_tree, adapters_by_name)``: the base keeps the model's
    structure (kernels unmerged), the adapters come back as a flat
    slash-joined-name → tensor dict (the adapter artifact's unit)."""
    adapters: dict = {}

    def walk(node: dict, prefix: str) -> dict:
        out = {}
        for key, value in node.items():
            full = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = walk(value, full + "/")
            elif is_adapter_name(key):
                adapters[full] = value
            else:
                out[key] = value
        return out

    return walk(params, ""), adapters


def combine_adapters(base_params: dict, adapters: dict) -> dict:
    """Graft flat-named adapter leaves into a copy of the base tree's
    dicts (the inverse of ``split_adapters``); a name whose scope the base
    lacks raises ``KeyError``."""

    def copy(node: Any) -> Any:
        return {k: copy(v) for k, v in node.items()} \
            if isinstance(node, dict) else node

    out = copy(base_params)
    for name, leaf in adapters.items():
        parts = name.split("/")
        node = out
        for part in parts[:-1]:
            child = node.get(part)
            if not isinstance(child, dict):
                raise KeyError(
                    f"adapter leaf {name!r} does not fit the base tree — "
                    f"missing scope {part!r}")
            node = child
        node[parts[-1]] = leaf
    return out


def adapter_mask(tree: dict) -> dict:
    """Nested bools over ``tree``: True exactly on adapter leaves. The one
    trainability mask: ``lora_optimizer`` and ``trainable_params_frac``
    both read it."""

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return any(s in path for s in ADAPTER_SUFFIXES)

    return walk(tree, "")


def _mask_leaves(tree: dict) -> list:
    """``adapter_mask`` as a flat list in ``tree_leaves_with_path``
    order."""
    return [m for _, m in tree_leaves_with_path(adapter_mask(tree))]


def _adapter_tree(params: dict) -> dict:
    """The subtree of adapter leaves (same nesting, base leaves gone)."""
    out: dict = {}
    for path, leaf in tree_leaves_with_path(params):
        if is_adapter_name(path[-1]):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
    return out


class LoRAOptimizer:
    """An optimizer that updates only the adapter leaves (port of
    ``lora.lora_optimizer``'s ``optax.masked`` pair).

    The engine hands it the full flat parameter and grad lists; it takes
    the global norm over all of them (the clip's norm and the logged
    ``grad_norm``), then runs the inner ``AdamW`` on the adapter subset
    with that norm. The inner state (its ``mu`` / ``nu``) covers the
    adapters alone, and no base leaf is written."""

    def __init__(self, inner: Any):
        self.inner = inner
        self._index: Optional[list] = None

    def _select(self, params: dict) -> list:
        idx = [i for i, m in enumerate(_mask_leaves(params)) if m]
        if not idx:
            raise ValueError("the parameters carry no adapter leaves — "
                             "nothing to train (inject_adapters first)")
        return idx

    def init(self, params: dict) -> dict:
        """The inner state over the adapter subtree."""
        self._index = self._select(params)
        return self.inner.init(_adapter_tree(params))

    def grad_norm(self, grads: list, grad_scale: float = 1.0,
                  axes: Optional[list] = None, mesh: Any = None
                  ) -> torch.Tensor:
        """The global norm of every grad, base leaves included (over a
        mesh's blocks with ``axes`` / ``mesh``)."""
        return self.inner.grad_norm(grads, grad_scale, axes, mesh)

    def update(self, params: list, grads: list, state: dict,
               g_norm: Optional[torch.Tensor] = None,
               grad_scale: float = 1.0) -> torch.Tensor:
        """One inner step on the adapter leaves, clipped by the norm of
        all grads; returns that norm."""
        if g_norm is None:
            g_norm = self.grad_norm(grads, grad_scale)
        idx = self._index
        self.inner.update([params[i] for i in idx], [grads[i] for i in idx],
                          state, g_norm=g_norm, grad_scale=grad_scale)
        return g_norm

    def flat_state(self, state: dict, params: dict) -> dict:
        """The inner state's flat checkpoint dict (``mu/<adapter path>``
        etc.)."""
        return self.inner.flat_state(state, _adapter_tree(params))

    def load_flat_state(self, state: dict, flat: dict, params: dict) -> None:
        """Restore ``flat_state`` output, bit for bit."""
        self.inner.load_flat_state(state, flat, _adapter_tree(params))


def lora_optimizer(inner: Any) -> LoRAOptimizer:
    """Mask an optimizer so only adapter leaves ever update."""
    return LoRAOptimizer(inner)


def trainable_params_frac(params: dict) -> float:
    """Trainable (adapter) parameter count over the total."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(params)]
    total = sum(int(leaf.numel()) for leaf in leaves)
    trainable = sum(int(leaf.numel()) for leaf, m
                    in zip(leaves, _mask_leaves(params)) if m)
    return trainable / max(total, 1)


def base_leaf_digests(params: dict) -> dict:
    """Per-leaf content digests of the base (non-adapter) leaves, by
    slash-joined name: the frozen-base identity an adapter artifact stamps
    at save and re-checks at restore. A bf16 leaf is digested over its
    raw bits, as the JAX package digests its ml_dtypes leaves."""
    out = {}
    for name, leaf in ckpt_lib.flatten(params).items():
        if not is_adapter_name(name):
            out[name] = integrity.digest_array(ckpt_lib._to_host(leaf)[0])
    return out
