"""Symmetric int8 fake-quant with straight-through gradients (port of
``fleetx_tpu/ops/quantization.py``).

``fake_quant(x, bits, axis)`` rounds ``x`` onto the grid ``k · scale``,
``|k| <= qmax = 2**(bits-1) - 1``, where ``scale = max(amax / qmax,
1e-8)`` and ``amax`` is the largest ``|x|`` over the reduced ``axis``
(all of ``x`` when ``axis`` is None: one per-tensor scale; kept dims
otherwise: one scale per remaining index). Every step computes in
``x``'s dtype, as the JAX function does: the scale is cast to ``x.dtype``
before it divides, and the result is ``x + (q - x).detach()``, not ``q``
(in bf16 the two can differ by an ulp). ``torch.round`` rounds half to
even, as ``jnp.round`` does. The gradient is the identity.

``quantize_weight`` reduces over every dim but the output one (one scale
per output channel); ``quantize_act`` is the per-tensor case. The JAX
function is plain jnp (no Pallas kernel), so this is plain PyTorch too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["fake_quant", "quantize_weight", "quantize_act"]

Axis = Optional[Union[int, Sequence[int]]]


def fake_quant(x: torch.Tensor, bits: int = 8, axis: Axis = None,
               amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Simulated symmetric quantisation with straight-through gradients.
    ``amax`` replaces the abs-max of ``x`` (a tensor's whole abs-max when
    each rank of a mesh holds a slice of it)."""
    qmax = float(2 ** (bits - 1) - 1)
    if amax is not None:
        pass
    elif axis is None:
        amax = x.detach().abs().amax()
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        amax = x.detach().abs().amax(dim=dims, keepdim=True)
    # divide by a tensor on x's device: a CUDA division by a host scalar
    # multiplies by its reciprocal, which is not the JAX quotient
    q_t = torch.full((), qmax, dtype=x.dtype, device=x.device)
    floor = torch.full((), 1e-8, dtype=x.dtype, device=x.device)
    scale = torch.maximum(amax / q_t, floor)
    q = torch.clamp(torch.round(x.detach() / scale), -qmax, qmax) * scale
    return x + (q - x).detach()


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    out_axis: int = -1) -> torch.Tensor:
    """Per-output-channel weight fake-quant (paddleslim
    'channel_wise_abs_max')."""
    out_axis %= w.dim()
    axes = tuple(i for i in range(w.dim()) if i != out_axis)
    return fake_quant(w, bits=bits, axis=axes)


def quantize_act(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor activation fake-quant (the abs-max scale recomputed on
    every call)."""
    return fake_quant(x, bits=bits, axis=None)
