"""The sharded training step's placement and its differentiable
collectives (the port's counterpart of ``fleetx_tpu/parallel/sharding.py``).

JAX states where every leaf lives (``zero_sharding``, ``zero_grad_specs``,
the logical-axis table) and GSPMD inserts the collectives. Here each rank
is a process and every collective is written by hand:

- ``zero_sharding`` / ``zero_grad_specs``: the ZeRO-1/2 optimizer-state
  and ZeRO-2 gradient specs of a tree of leaves, through the same
  ``rules.with_fsdp_axis`` policy as the JAX helpers;
- the regions of Megatron's tensor and sequence parallelism as
  ``torch.autograd.Function``s: ``copy_to_tensor`` (identity forward,
  psum backward), ``reduce_from_tensor`` (psum forward, identity
  backward), ``gather_seq`` / ``scatter_seq`` (all-gather along the
  sequence forward with a reduce-scatter backward, and the reverse) and
  ``gather_fsdp`` (ZeRO-3's weight gather: all-gather over ``fsdp``
  forward, reduce-scatter backward);
- ``global_sum``: a psum over the data axes forward and the identity
  backward, which turns a rank's share of a batch statistic into the
  global statistic while its grads stay the rank's share (the engine sums
  the shares in its grad sync);
- ``ShardCtx``: what a sharded forward needs (the mesh, sequence
  parallelism, the leaves the forward gathers over ``fsdp``), and the
  global coordinates of the rank's rows, sequence block and heads, from
  which every dropout mask is drawn;
- ``LeafPlan`` / ``plan_leaves``: where the engine keeps each parameter,
  its moments and its gradient; ``narrow_to`` takes a rank's block of a
  whole leaf in place (``rules.shard_leaf`` a copy's), ``gather_leaf``
  the whole leaf back (a save, the fingerprint);
  ``batch_rows`` a rank's rows of a global batch.

Every function is the identity (or a plain slice) at axis size 1, so a
one-rank run goes through the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from fleetx_tpu_torch.parallel import mesh as M
from fleetx_tpu_torch.parallel.rules import (SpecLayout, spec_for,
                                             with_fsdp_axis)

#: the axes a batch's rows are spread over (``rules.batch_spec``)
DATA_AXES = ("data", "fsdp")


# ------------------------------------------------------------ ZeRO specs
def zero_sharding(shapes: dict, specs: dict, size: int,
                  axis: str = "fsdp") -> dict:
    """ZeRO-1/2 optimizer-state specs: a leaf that carries no mesh axis
    gets ``axis`` on its first dim divisible by ``size``; a leaf already
    sharded (tensor parallel) keeps its spec (JAX's ``zero_sharding``)."""
    return {k: with_fsdp_axis(tuple(shapes[k]), specs[k], size, axis=axis,
                              only_if_replicated=True) for k in shapes}


def zero_grad_specs(shapes: dict, specs: dict, size: int,
                    axis: str = "fsdp") -> dict:
    """ZeRO-2 gradient specs: each leaf keeps its spec and takes ``axis``
    on its first free dim divisible by ``size`` (JAX's
    ``zero_grad_specs``)."""
    return {k: with_fsdp_axis(tuple(shapes[k]), specs[k], size, axis=axis)
            for k in shapes}


def axes_of(spec) -> tuple:
    """Every mesh axis a spec names, in order."""
    out = []
    for entry in spec:
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                out.append(a)
    return tuple(out)


def dim_of(spec, axis: str) -> Optional[int]:
    """The dim a spec puts ``axis`` on, or None."""
    for d, entry in enumerate(spec):
        if axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            return d
    return None


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``;
    every split must be even (the collectives move equal blocks)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = 1
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                n *= mesh.shape[a]
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n} ranks ({spec})")
        out[d] //= n
    return tuple(out)


# ------------------------------------------------ differentiable regions
class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return M.psum(g, "tensor", ctx.mesh), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return M.psum(x, "tensor", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim`` forward, reduce-scatter
    backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return M.all_gather(x, axis, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.args
        return M.reduce_scatter(g, axis, mesh, dim=dim), None, None, None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter over ``axis`` along ``dim`` forward, all-gather
    backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return M.reduce_scatter(x, axis, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.args
        return M.all_gather(g, axis, mesh, dim=dim), None, None, None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return M.psum_axes(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _trivial(mesh, *axes) -> bool:
    return mesh is None or all(mesh.shape.get(a, 1) == 1 for a in axes)


def copy_to_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward, psum backward."""
    return x if _trivial(mesh, "tensor") else _CopyToTensor.apply(x, mesh)


def reduce_from_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """Leave a row-parallel product: psum forward, identity backward."""
    return x if _trivial(mesh, "tensor") else \
        _ReduceFromTensor.apply(x, mesh)


def gather_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """Sequence shards → the whole sequence (all-gather over ``tensor``
    forward, reduce-scatter backward)."""
    return x if _trivial(mesh, "tensor") else \
        _GatherDim.apply(x, "tensor", dim, mesh)


def scatter_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """A row-parallel product's partial sums → this rank's summed
    sequence block (reduce-scatter forward, all-gather backward)."""
    return x if _trivial(mesh, "tensor") else \
        _ScatterDim.apply(x, "tensor", dim, mesh)


def gather_fsdp(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """ZeRO-3's weight gather: the whole leaf from the ``fsdp`` blocks
    (all-gather forward, reduce-scatter backward)."""
    return x if _trivial(mesh, "fsdp") else \
        _GatherDim.apply(x, "fsdp", dim, mesh)


def global_sum(x: torch.Tensor, mesh,
               axes: tuple = DATA_AXES) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` forward, the identity
    backward."""
    return x if _trivial(mesh, *axes) else _GlobalSum.apply(x, axes, mesh)


# ---------------------------------------------------------- the forward
@dataclasses.dataclass
class ShardCtx:
    """What a sharded forward reads. ``gather`` maps a parameter path
    (``gpt/layers/attn/qkv_kernel``) to the dim of the full leaf the
    forward all-gathers over ``fsdp`` (ZeRO stage 3)."""

    mesh: Any
    sequence_parallel: bool = False
    gather: dict = dataclasses.field(default_factory=dict)

    @property
    def tensor(self) -> int:
        return self.mesh.shape["tensor"]

    @property
    def sp(self) -> bool:
        """Sequence parallelism is on and does something."""
        return self.sequence_parallel and self.tensor > 1

    @property
    def data_world(self) -> int:
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    def data_index(self) -> int:
        """This rank's block of the batch rows (``data`` outer)."""
        return self.block(DATA_AXES, 1)[0]

    def block(self, axis_or_axes, size: int) -> tuple:
        """``(offset, total)`` of this rank's block of ``size`` along a
        dim split over the axes."""
        axes = (axis_or_axes,) if isinstance(axis_or_axes, str) \
            else tuple(axis_or_axes)
        n, at = 1, 0
        for a in axes:
            n *= self.mesh.shape[a]
            at = at * self.mesh.shape[a] + self.mesh.axis_index(a)
        return at * size, n * size

    def gathered(self, path: str, leaf: torch.Tensor,
                 stacked: bool = False) -> torch.Tensor:
        """``leaf`` whole over ``fsdp`` where the forward gathers it;
        ``stacked``: ``leaf`` is one layer of the stacked leaf ``path``
        (its dims shift down by one)."""
        dim = self.gather.get(path)
        if dim is None:
            return leaf
        return gather_fsdp(leaf, dim - 1 if stacked else dim, self.mesh)


def global_draw(draw, shape: tuple, blocks: dict) -> torch.Tensor:
    """``draw(full_shape)`` of the GLOBAL tensor ``shape`` with each dim
    in ``blocks`` (dim → ``(offset, total)``) widened to its total, sliced
    back to this rank's block: every rank draws the same numbers from the
    shared generator and keeps its own, so the generators stay in
    lockstep and the draws are one rank's draws."""
    full = list(shape)
    for d, (_, total) in blocks.items():
        full[d] = total
    u = draw(tuple(full))
    for d, (off, _) in blocks.items():
        u = u.narrow(d, off, shape[d])
    return u


def global_rand(shape: tuple, blocks: dict, gen: torch.Generator,
                device) -> torch.Tensor:
    """``torch.rand`` of this rank's block of a global tensor
    (``global_draw``)."""
    return global_draw(lambda full: torch.rand(full, generator=gen,
                                               device=device), shape, blocks)


def data_mean(x: torch.Tensor, shard: Optional["ShardCtx"]) -> torch.Tensor:
    """The global batch's mean from a rank's mean over its rows (every
    data rank holds as many rows): ``global_sum`` over the data ranks."""
    if shard is None:
        return x
    return global_sum(x, shard.mesh) / shard.data_world


# ------------------------------------------------------ the engine's plan
@dataclasses.dataclass
class LeafPlan:
    """Where one parameter lives.

    ``param``: its spec as the rules give it (tensor parallel, and the
    ``embed`` dims over ``fsdp`` at stage 3); ``stored``: what the engine
    keeps (``param``, or the gradient spec under ``overlap_update``);
    ``moment``: the optimizer state's spec (``zero_sharding`` at stages 1
    and 2); ``grad``: the gradient's (``zero_grad_specs`` at stage 2 and
    above)."""

    shape: tuple
    param: tuple
    stored: tuple
    moment: tuple
    grad: tuple

    @property
    def fwd_gather(self) -> Optional[int]:
        """The dim the forward all-gathers over ``fsdp`` (stage 3)."""
        return dim_of(self.param, "fsdp")

    @property
    def pre_gather(self) -> Optional[int]:
        """The dim the engine all-gathers before the loss
        (``overlap_update``)."""
        d = dim_of(self.stored, "fsdp")
        return d if d is not None and d != self.fwd_gather else None


def plan_leaves(shapes: dict, family: str, layout: SpecLayout, mesh,
                overlap_update: bool = False) -> dict:
    """Path → ``LeafPlan`` for a tree of full leaf shapes (path keys as
    ``rules.spec_for`` names them)."""
    fsdp = mesh.shape["fsdp"]
    params = {k: spec_for(family, k, tuple(s), layout)
              for k, s in shapes.items()}
    stage = layout.stage
    moments = zero_sharding(shapes, params, fsdp) \
        if stage in (1, 2) and fsdp > 1 else dict(params)
    grads = zero_grad_specs(shapes, params, fsdp) \
        if stage >= 2 and fsdp > 1 else dict(params)
    stored = grads if overlap_update and stage >= 2 and fsdp > 1 \
        else params
    return {k: LeafPlan(tuple(shapes[k]), params[k], stored[k], moments[k],
                        grads[k]) for k in shapes}


def gather_leaf(t: torch.Tensor, spec, mesh,
                axes: Optional[tuple] = None) -> torch.Tensor:
    """The blocks of ``t`` under ``spec`` gathered back along each dim
    (over every axis of the spec, or those in ``axes``); not
    differentiable."""
    for d, entry in enumerate(spec):
        names = [a for a in (entry if isinstance(entry, (tuple, list))
                             else (entry,)) if a is not None]
        for a in reversed(names):  # the inner axis first
            if axes is None or a in axes:
                t = M.all_gather(t, a, mesh, dim=d)
    return t


def narrow_to(t: torch.Tensor, spec, axis: str, mesh) -> torch.Tensor:
    """The view of ``t`` (whole along ``axis``'s dim of ``spec``) that is
    this rank's block of that dim."""
    d = dim_of(spec, axis)
    if d is None or mesh.shape[axis] == 1:
        return t
    n = t.shape[d] // mesh.shape[axis]
    return t.narrow(d, mesh.axis_index(axis) * n, n)


def batch_rows(batch: dict, mesh, accumulate_steps: int = 1) -> dict:
    """This rank's rows of a global host batch (``rules.batch_spec``: the
    rows over ``(data, fsdp)``). Each of the ``accumulate_steps``
    microbatches of the global batch is split over the ranks, so the
    rank's k-th microbatch is its block of the global k-th microbatch,
    as the JAX step's reshape to ``[accumulate, rows / accumulate]``
    places it."""
    n = mesh.shape["data"] * mesh.shape["fsdp"]
    if n == 1:
        return batch
    at = mesh.axis_index("data") * mesh.shape["fsdp"] + \
        mesh.axis_index("fsdp")
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % (n * accumulate_steps):
            raise ValueError(f"global batch of {rows} rows does not split "
                             f"into {accumulate_steps} microbatches over "
                             f"{n} data ranks")
        m = rows // (n * accumulate_steps)
        out[k] = v.reshape(accumulate_steps, n, m, *v.shape[1:])[:, at] \
            .reshape(accumulate_steps * m, *v.shape[1:])
    return out

