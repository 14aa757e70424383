"""Partition rules of the port: the rule tables and ZeRO helpers of
``fleetx_tpu/parallel/rules.py``, as plain data.

The JAX registry maps named parameter leaves to ``PartitionSpec``s that
GSPMD places; here a spec is a tuple of mesh-axis names (``None`` for a
replicated dim, trailing ``None``s dropped, as JAX's canonical form), and
``shard_leaf`` cuts the slice of one rank out of a full leaf. The names,
tables and resolution order are the JAX module's:

- ``MESH_AXES``: the axis vocabulary ``(pipe, data, fsdp, seq, tensor)``;
- ``SpecLayout``: the logical → mesh table (``axis_rules``,
  ``mesh_entry``, ``to_mesh``, ``from_dist_config``);
- ``PARTITION_RULES``: the families ``gpt``, ``gpt_moe``, ``gpt_lora``,
  ``vision``, ``ernie``, ``imagen`` (``:208-323``) and the ``serving_kv``
  pool;
- ``spec_for`` (``:388``) and ``kv_pool_spec`` (``:541``);
- the ZeRO helpers ``first_free_divisible_dim``, ``with_fsdp_axis``,
  ``ZERO_STAGE_TERMS`` / ``stage_shards`` and ``batch_spec``
  (``:484-556``).

``shard_tree`` is the one place a rank's weights are cut: it applies
``shard_leaf`` to every leaf of a full parameter dict under the family's
rules.

The static audits (``audit_leaves``, ``registry_fingerprint``) come with
a later part of distributed training (ROADMAP.md, port queue item 12).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Optional

#: the mesh axis vocabulary (``parallel/mesh.py`` lays its ranks out in
#: this order, ``tensor`` innermost)
MESH_AXES = ("pipe", "data", "fsdp", "seq", "tensor")

#: leading stack axes of stacked layer leaves, outermost first; a stacked
#: leaf with k extra leading dims takes the LAST k entries
STACK_AXES = ("pipe_repeat", "pipe_stage", "layers")


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Logical → mesh mapping for one run's layout: the ZeRO ``stage``
    decides whether ``embed`` shards over ``fsdp`` (stage 3), and
    ``sequence_parallel`` spreads ``act_seq`` over ``tensor`` too."""

    stage: int = 0
    sequence_parallel: bool = False

    @classmethod
    def from_dist_config(cls, dist_config: Optional[dict]) -> "SpecLayout":
        """Layout from a ``Distributed:`` config section."""
        cfg = dist_config or {}
        stage = int((cfg.get("sharding") or {}).get("sharding_stage") or 0)
        return cls(stage=stage,
                   sequence_parallel=bool(cfg.get("sequence_parallel")))

    def axis_rules(self) -> tuple:
        """The logical → mesh table (the JAX module's, entry for entry)."""
        act_seq: Any = ("seq", "tensor") if self.sequence_parallel \
            else ("seq",)
        return (
            ("batch", ("data", "fsdp")),
            ("vocab", "tensor"),
            ("mlp", "tensor"),
            ("heads", "tensor"),
            ("kv", None),
            ("layers", None),
            ("pipe_stage", "pipe"),
            ("pipe_repeat", None),
            ("act_stage", "pipe"),
            ("norm", None),
            ("embed", "fsdp" if self.stage >= 3 else None),
            ("act_seq", act_seq),
            ("act_embed", None),
            ("act_heads", "tensor"),
            ("act_kv", None),
            ("act_vocab", "tensor"),
            ("expert", "tensor"),
            ("act_expert", "tensor"),
            ("kv_pages", "fsdp"),
            ("page_slot", None),
        )

    def mesh_entry(self, logical: Optional[str]) -> Any:
        """Mesh axis (or axes tuple, or None) for one logical name."""
        if logical is None:
            return None
        table = dict(self.axis_rules())
        if logical not in table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return table[logical]

    def to_mesh(self, template: Iterable[Optional[str]]) -> tuple:
        """Logical template → canonical mesh-axes tuple. A mesh axis is
        used once per spec: the logical axis earlier in the rule table
        keeps it, a later one replicates."""
        template = tuple(template)
        order = {name: i for i, (name, _) in enumerate(self.axis_rules())}
        entries = [self.mesh_entry(a) for a in template]
        resolved: list = [None] * len(entries)
        used: set = set()
        for i in sorted(range(len(entries)),
                        key=lambda i: (order.get(template[i], len(order)),
                                       i)):
            entry = entries[i]
            axes = tuple(a for a in (
                entry if isinstance(entry, (tuple, list)) else (entry,))
                if a is not None)
            if axes and not used.intersection(axes):
                used.update(axes)
                resolved[i] = entry
        return canonicalize(resolved)


#: the template of a leaf that replicates by declaration (Imagen)
REPLICATED = "replicated"

_GPT_ATTN_RULES = (
    (r"attn/qkv_kernel$", ("embed", None, "heads", "kv")),
    (r"attn/qkv_bias$", (None, "heads", "kv")),
    (r"attn/out_kernel$", ("heads", "kv", "embed")),
    (r"attn/out_bias$", ("embed",)),
)

_GPT_DENSE_MLP_RULES = (
    (r"mlp/wi_kernel$", ("embed", "mlp")),
    (r"mlp/wi_bias$", ("mlp",)),
    (r"mlp/wo_kernel$", ("mlp", "embed")),
    (r"mlp/wo_bias$", ("embed",)),
)

_GPT_MOE_MLP_RULES = (
    (r"mlp/router_kernel$", ("embed", None)),
    (r"mlp/wi_kernel$", ("expert", "embed", "mlp")),
    (r"mlp/wi_bias$", ("expert", "mlp")),
    (r"mlp/wo_kernel$", ("expert", "mlp", "embed")),
    (r"mlp/wo_bias$", ("expert", None)),
)

_GPT_COMMON_RULES = (
    (r"embeddings/word_embeddings$", ("vocab", "embed")),
    (r"embeddings/position_embeddings$", (None, "embed")),
    (r"(ln1|ln2|ln_f)/(scale|bias)$", ("norm",)),
)

# LoRA adapters: A replicates, B takes its base leaf's output-side axis
_GPT_LORA_RULES = (
    (r"attn/qkv_kernel_lora_a$", (None, None)),
    (r"attn/qkv_kernel_lora_b$", (None, None, "heads", "kv")),
    (r"attn/out_kernel_lora_a$", (None, None, None)),
    (r"attn/out_kernel_lora_b$", (None, "embed")),
    (r"mlp/wi_kernel_lora_a$", (None, None)),
    (r"mlp/wi_kernel_lora_b$", (None, "mlp")),
    (r"mlp/wo_kernel_lora_a$", (None, None)),
    (r"mlp/wo_kernel_lora_b$", (None, "embed")),
)

#: family → ordered (regex, logical template) rules; first match wins.
#: Templates name the TRAILING feature axes; stacked leaves get their
#: leading dims from ``STACK_AXES`` (``STACK_MARKERS``)
PARTITION_RULES: dict = {
    "gpt": _GPT_ATTN_RULES + _GPT_DENSE_MLP_RULES + _GPT_COMMON_RULES,
    "gpt_moe": _GPT_ATTN_RULES + _GPT_MOE_MLP_RULES + _GPT_COMMON_RULES,
    "gpt_lora": _GPT_LORA_RULES + _GPT_ATTN_RULES + _GPT_DENSE_MLP_RULES
    + _GPT_COMMON_RULES,
    "vision": _GPT_ATTN_RULES + _GPT_DENSE_MLP_RULES + (
        (r"(ln1|ln2|ln_f)/(scale|bias)$", ("norm",)),
        (r"(^|/)cls_token$", (None, None, "embed")),
        (r"(^|/)pos_embed$", (None, None, "embed")),
        (r"(^|/)patch_kernel$", (None, None, None, "embed")),
        (r"(^|/)patch_bias$", ("embed",)),
        (r"(^|/)head_kernel$", ("embed", "vocab")),
        (r"(^|/)head_bias$", ("vocab",)),
    ),
    "ernie": _GPT_ATTN_RULES + (
        (r"layers/wi_kernel$", ("embed", "mlp")),
        (r"layers/wi_bias$", ("mlp",)),
        (r"layers/wo_kernel$", ("mlp", "embed")),
        (r"layers/wo_bias$", ("embed",)),
        (r"(ln1|ln2|embed_ln|mlm_ln)/(scale|bias)$", ("norm",)),
        (r"word_embeddings$", ("vocab", "embed")),
        (r"(position|token_type)_embeddings$", (None, "embed")),
        (r"pooler_kernel$", ("embed", None)),
        (r"pooler_bias$", ("embed",)),
        (r"(^|/)mlm_transform_kernel$", ("embed", None)),
        (r"(^|/)mlm_transform_bias$", ("embed",)),
        (r"(^|/)mlm_bias$", ("vocab",)),
        (r"(^|/)nsp_kernel$", ("embed", None)),
        (r"(^|/)nsp_bias$", (None,)),
    ),
    # the diffusion stages are data-parallel only: every leaf replicates
    # by declaration
    "imagen": (
        (r".", REPLICATED),
    ),
    # the serving KV page pool: pages over the ZeRO axis, heads over the
    # Megatron axis
    "serving_kv": (
        (r"kv_pool/(k|v)$",
         ("layers", "kv_pages", "page_slot", "heads", "kv")),
    ),
}

#: family → regex marking stacked-layer leaves
STACK_MARKERS: dict = {
    "gpt": r"(^|/)layers/",
    "gpt_moe": r"(^|/)layers/",
    "gpt_lora": r"(^|/)layers/",
    "vision": r"(^|/)blocks/",
    "ernie": r"(^|/)layers/",
}


def canonicalize(entries: Iterable[Any]) -> tuple:
    """Drop trailing Nones (the one spelling of a spec)."""
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_scalar(shape: tuple) -> bool:
    size = 1
    for d in shape:
        size *= int(d)
    return len(shape) == 0 or size == 1


def _stack_padded(family: str, name: str, template: tuple,
                  ndim: int) -> tuple:
    """Template → full-rank logical tuple, padding stacked leading dims."""
    if template == REPLICATED:
        return (None,) * ndim
    tpl = tuple(template)
    if len(tpl) == ndim:
        return tpl
    marker = STACK_MARKERS.get(family)
    extra = ndim - len(tpl)
    if marker and re.search(marker, name) and 0 < extra <= len(STACK_AXES):
        return STACK_AXES[-extra:] + tpl
    raise ValueError(
        f"partition rule for {name!r} (family {family!r}) has {len(tpl)} "
        f"axes but the leaf has rank {ndim} and no stack marker applies")


def spec_for(family: str, name: str, shape: tuple,
             layout: Optional[SpecLayout] = None) -> tuple:
    """Canonical mesh-axes tuple for one named leaf (first match wins;
    scalars and size-1 leaves replicate; an unmatched leaf raises)."""
    layout = layout or SpecLayout()
    if _is_scalar(tuple(shape)):
        return ()
    if family not in PARTITION_RULES:
        raise KeyError(f"unknown spec family {family!r}; the port has "
                       f"{sorted(PARTITION_RULES)}")
    for pattern, template in PARTITION_RULES[family]:
        if re.search(pattern, name):
            return layout.to_mesh(
                _stack_padded(family, name, template, len(shape)))
    raise KeyError(f"no partition rule in family {family!r} matches leaf "
                   f"{name!r}")


def kv_pool_spec(layout: Optional[SpecLayout] = None) -> tuple:
    """The serving KV pool's placement: pages over ``fsdp``, heads over
    ``tensor`` (``(None, "fsdp", None, "tensor")``)."""
    return spec_for("serving_kv", "kv_pool/k", (1, 2, 2, 2, 2),
                    layout or SpecLayout())


# ------------------------------------------------ ZeRO helpers (stage 1-3)

def first_free_divisible_dim(shape: Iterable[int], spec: Iterable[Any],
                             size: int) -> Optional[int]:
    """First still-replicated dim divisible by (and at least) ``size``:
    where a ZeRO axis may land."""
    spec = list(spec)
    for dim, d in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None and int(d) % size == 0 and int(d) >= size:
            return dim
    return None


def with_fsdp_axis(shape: tuple, spec: Iterable[Any], size: int,
                   axis: str = "fsdp",
                   only_if_replicated: bool = False) -> tuple:
    """A canonical spec augmented with the ZeRO axis.

    ``only_if_replicated`` is the optimizer-state mode (stage 1/2
    ``zero_sharding``): a leaf already carrying any mesh axis keeps its
    spec. Otherwise (the gradient mode, ``zero_grad_specs``) the existing
    entries stay and ``axis`` lands on the first free divisible dim,
    unless the spec already uses it."""
    entries = list(spec)
    entries += [None] * (len(shape) - len(entries))
    used = set()
    for entry in entries:
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                used.add(a)
    if only_if_replicated and used:
        return canonicalize(entries)
    if size > 1 and axis not in used:
        if only_if_replicated:
            entries = [None] * len(shape)
        dim = first_free_divisible_dim(shape, entries, size)
        if dim is not None:
            entries[dim] = axis
    return canonicalize(entries)


#: which memory term each ZeRO stage starts sharding over fsdp
ZERO_STAGE_TERMS = {"moments": 1, "grads": 2, "weights": 3}


def stage_shards(term: str, stage: int) -> bool:
    """True when ZeRO ``stage`` shards ``term`` over the fsdp axis."""
    return stage >= ZERO_STAGE_TERMS[term]


def batch_spec() -> tuple:
    """Global-batch placement: the ``batch`` logical axis' mesh entry,
    ``(("data", "fsdp"),)`` (dp × sharding is the data world)."""
    return canonicalize((SpecLayout().mesh_entry("batch"),))


def block_range(size: int, parts: int, index: int) -> tuple:
    """``[lo, hi)`` of block ``index`` when a dim of ``size`` splits into
    ``parts`` contiguous blocks of ``ceil(size / parts)`` (the last may be
    short, as JAX pads an uneven sharding)."""
    step = -(-int(size) // int(parts))
    lo = min(int(index) * step, int(size))
    return lo, min(lo + step, int(size))


def shard_leaf(array: Any, spec: Iterable[Any], mesh: Any,
               keep: Iterable[str] = ()) -> Any:
    """This rank's contiguous slice of a full leaf under ``spec``.

    Each dim whose entry names mesh axes is cut into their combined
    degree of blocks (the first axis outermost), and the block at this
    rank's coordinates is kept; axes in ``keep`` (and axes of size 1)
    leave their dim whole. Works on anything that slices like a tensor.
    """
    keep = set(keep)
    index = []
    for dim, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, (tuple, list))
                            else (entry,))
                if a is not None and a not in keep and mesh.shape[a] > 1]
        if not axes:
            index.append(slice(None))
            continue
        parts, at = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            at = at * mesh.shape[a] + mesh.axis_index(a)
        lo, hi = block_range(array.shape[dim], parts, at)
        index.append(slice(lo, hi))
    return array[tuple(index)]


def shard_tree(tree: dict, mesh: Any, layout: Optional[SpecLayout] = None,
               family: str = "gpt") -> dict:
    """This rank's slices of every leaf of a full nested parameter dict
    under the ``family`` rules and ``layout``, for serving: a dim on
    ``tensor`` is cut; an ``fsdp`` entry (ZeRO stage 3's ``embed``) keeps
    its dim whole, since a serving replica holds its weights. A cut leaf
    is a copy of its slice alone (the full leaf is not kept alive)."""

    def walk(node: Any, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{name}/{k}" if name else k)
                    for k, v in node.items()}
        cut = shard_leaf(node, spec_for(family, name, tuple(node.shape),
                                        layout), mesh, keep=("fsdp",))
        return cut.clone() if tuple(cut.shape) != tuple(node.shape) \
            else node

    return walk(tree, "")
