"""Composable batch-collate helpers (a copy of
``fleetx_tpu/data/sampler/collate.py:19-102``): each is a callable over a
list of per-sample fields; ``Tuple`` and ``Dict`` route the components
of a sample to one collator each. Numpy only.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["Stack", "Pad", "Tuple", "Dict"]


class Stack:
    """Stack equal-shape fields into ``[batch, ...]``; optional dtype
    cast."""

    def __init__(self, dtype=None, axis: int = 0):
        self.dtype = dtype
        self.axis = axis

    def __call__(self, data: Sequence[Any]) -> np.ndarray:
        out = np.stack([np.asarray(d) for d in data], axis=self.axis)
        return out.astype(self.dtype) if self.dtype else out


class Pad:
    """Pad ragged fields along ``axis`` to the batch's longest and stack;
    ``ret_length`` also returns the true lengths, ``pad_right=False``
    pads on the left."""

    def __init__(self, pad_val=0, axis: int = 0, ret_length: bool = False,
                 dtype=None, pad_right: bool = True):
        self.pad_val = pad_val
        self.axis = axis
        self.ret_length = ret_length
        self.dtype = dtype
        self.pad_right = pad_right

    def __call__(self, data: Sequence[Any]):
        arrays = [np.asarray(d) for d in data]
        lengths = np.array([a.shape[self.axis] for a in arrays], np.int64)
        max_len = int(lengths.max()) if len(arrays) else 0
        out = []
        for a in arrays:
            pad_width = [(0, 0)] * a.ndim
            need = max_len - a.shape[self.axis]
            pad_width[self.axis] = (0, need) if self.pad_right else (need, 0)
            out.append(np.pad(a, pad_width, constant_values=self.pad_val))
        batch = np.stack(out)
        if self.dtype:
            batch = batch.astype(self.dtype)
        if self.ret_length:
            return batch, lengths
        return batch


class Tuple:
    """Route the components of tuple / list samples to one collator each;
    a collator's ``(batch, lengths)`` pair is flattened into the output."""

    def __init__(self, *fn: Callable):
        if len(fn) == 1 and isinstance(fn[0], (list, tuple)):
            fn = tuple(fn[0])
        self.fn = fn

    def __call__(self, data: Sequence[Sequence[Any]]):
        assert all(len(d) == len(self.fn) for d in data), \
            f"sample arity != {len(self.fn)} collators"
        out = []
        for i, f in enumerate(self.fn):
            result = f([d[i] for d in data])
            if isinstance(result, tuple):
                out.extend(result)
            else:
                out.append(result)
        return tuple(out)


class Dict:
    """Route dict sample fields to one collator per key; a ``(batch,
    lengths)`` pair lands under ``key`` and ``key + "_length"``."""

    def __init__(self, fn: dict):
        self.fn = dict(fn)

    def __call__(self, data: Sequence[dict]):
        out = {}
        for key, f in self.fn.items():
            result = f([d[key] for d in data])
            if isinstance(result, tuple):
                out[key] = result[0]
                out[key + "_length"] = result[1]
            else:
                out[key] = result
        return out
