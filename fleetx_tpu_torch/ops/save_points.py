"""Save points of the ``dots`` recompute granularity: the outputs a
checkpointed span keeps from its forward, so that its recomputation in
the backward takes them back instead of making them again.

JAX's ``dots`` remat policy (``fleetx_tpu/models/gpt/model.py:253-268``)
keeps every matmul output without batch dims, or, with a save-point
transform on, the four named post-bias residuals instead, and with flash
attention on every Pallas kernel's outputs; remat reruns the rest. Here
the same outputs are kept at the call sites that make them, each tagged
with its kind (``KINDS``):

- ``"kernel"``: the flash forward (``_Flash3``, the ring's
  ``_RingFlash3``) and the fused-norm forward (``_FusedAddNorm``,
  ``_FusedNorm``), in their ``autograd.Function.forward``;
- ``"dot"``: the matmul output of each of a layer's four projections;
- ``"residual"``: each projection's post-bias output in its save dtype.

``recording(points)`` runs a span's forward with ``points`` active: every
``kept(kind, compute)`` of a kind ``points`` keeps runs ``compute()`` and
appends its outputs. ``replaying(points)`` runs the recomputation: the
same calls, in the same order, take the kept outputs back (and drop the
span's reference to them, so the backward frees each as it goes) and
compute nothing; a kept kernel is therefore launched once. A kind the
span does not keep, and any call outside a span, just computes.

Why not ``torch.utils.checkpoint.create_selective_checkpoint_contexts``:
its policy sees every aten op of the span through a Python dispatch mode,
in the forward and again in the recomputation. At GPT-345M that made a
step host-bound, 247.85 ms against 121.29 ms without recompute and 153.71
ms with ``full`` recompute (one call, NVIDIA H100 80GB HBM3, 700.00 W,
``chip_smoke.py --gpt-knobs``). A save point costs one Python call.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional

#: what a span can keep
KINDS = ("kernel", "dot", "residual")


class SavePoints:
    """The outputs one span keeps, of the kinds ``kinds``."""

    def __init__(self, kinds: Iterable[str]):
        self.kinds = frozenset(kinds)
        unknown = self.kinds - set(KINDS)
        if unknown:
            raise ValueError(f"save point kinds {sorted(unknown)} are not "
                             f"in {KINDS}")
        self.outputs: list = []
        self.replay: Optional[int] = None   # the next output to take back


_active: Optional[SavePoints] = None


@contextlib.contextmanager
def _with(points: SavePoints):
    global _active
    outer, _active = _active, points
    try:
        yield points
    finally:
        _active = outer


def recording(points: SavePoints):
    """Run a span's forward: ``kept`` calls of ``points``' kinds keep
    their outputs."""
    points.outputs, points.replay = [], None
    return _with(points)


def replaying(points: SavePoints):
    """Rerun the span: ``kept`` calls of ``points``' kinds take the kept
    outputs back in order."""
    points.replay = 0
    return _with(points)


def kept(kind: str, compute: Callable):
    """``compute()``, kept by the active span when it keeps ``kind``."""
    points = _active
    if points is None or kind not in points.kinds:
        return compute()
    if points.replay is None:
        out = compute()
        points.outputs.append((kind, out))
        return out
    i = points.replay
    if i >= len(points.outputs) or points.outputs[i] is None \
            or points.outputs[i][0] != kind:
        raise RuntimeError(f"save point {i} ({kind}) was not kept by the "
                           f"forward: the recomputation took another path")
    (_, out), points.outputs[i] = points.outputs[i], None
    points.replay = i + 1
    return out
