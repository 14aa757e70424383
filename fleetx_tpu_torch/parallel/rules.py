"""Partition rules of the port: the serving and GPT subset of
``fleetx_tpu/parallel/rules.py``, as plain data.

The JAX registry maps named parameter leaves to ``PartitionSpec``s that
GSPMD places; here a spec is a tuple of mesh-axis names (``None`` for a
replicated dim, trailing ``None``s dropped, as JAX's canonical form), and
``shard_leaf`` cuts the slice of one rank out of a full leaf. The names,
tables and resolution order are the JAX module's:

- ``MESH_AXES``: the axis vocabulary ``(pipe, data, fsdp, seq, tensor)``;
- ``SpecLayout``: the logical → mesh table (``axis_rules``,
  ``mesh_entry``, ``to_mesh``, ``from_dist_config``);
- ``PARTITION_RULES``: the ``gpt`` family's leaf rules
  (``fleetx_tpu/parallel/rules.py:208-230``) and the ``serving_kv`` pool;
- ``spec_for`` (``:388``) and ``kv_pool_spec`` (``:541``).

``shard_tree`` is the one place a rank's weights are cut: it applies
``shard_leaf`` to every leaf of a full parameter dict under the family's
rules.

The ERNIE, ViT, MoE and LoRA families and the static audits come with
distributed training (ROADMAP.md, port queue item 12).
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


#: family → ordered (regex, logical template) rules; first match wins.
#: Templates name the TRAILING feature axes; stacked leaves get their
#: leading dims from ``STACK_AXES`` (``STACK_MARKERS``)
PARTITION_RULES: dict = {
    "gpt": (
        (r"attn/qkv_kernel$", ("embed", None, "heads", "kv")),
        (r"attn/qkv_bias$", (None, "heads", "kv")),
        (r"attn/out_kernel$", ("heads", "kv", "embed")),
        (r"attn/out_bias$", ("embed",)),
        (r"mlp/wi_kernel$", ("embed", "mlp")),
        (r"mlp/wi_bias$", ("mlp",)),
        (r"mlp/wo_kernel$", ("mlp", "embed")),
        (r"mlp/wo_bias$", ("embed",)),
        (r"embeddings/word_embeddings$", ("vocab", "embed")),
        (r"embeddings/position_embeddings$", (None, "embed")),
        (r"(ln1|ln2|ln_f)/(scale|bias)$", ("norm",)),
    ),
    # the serving KV page pool: pages over the ZeRO axis, heads over the
    # Megatron axis
    "serving_kv": (
        (r"kv_pool/(k|v)$",
         ("layers", "kv_pages", "page_slot", "heads", "kv")),
    ),
}

#: family → regex marking stacked-layer leaves
STACK_MARKERS: dict = {"gpt": r"(^|/)layers/"}


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
