"""Ring attention over the sequence: the long-context attention path.

Port of ``fleetx_tpu/ops/ring_attention.py``. In JAX the sequence is
sharded over the ``seq`` mesh axis and K/V blocks rotate around the ring
(``lax.ppermute``) while each device folds the incoming block into its
online softmax. The port trains on one device, so the ring has one
member: ``ring_attention`` takes the ring size (``Distributed.seq_degree``)
and raises ``NotImplementedError`` above 1 (ROADMAP.md, port queue item
12, with the rotation over ``torch.distributed``). At ring size 1 the
JAX code runs exactly what is here:

- ``ring_flash_local`` (JAX :132-253), where ``flash_ring_supported``
  admits the local block: the diagonal block's forward through
  ``fwd_call`` (the flash forward kernel), kept as ``(out f32, lse)`` for
  the online-logsumexp merge (``merge_blocks``) the later ring steps fold
  into; the backward computes ``delta`` from ``out`` in f32 and runs the
  split ``bwd_dq_call`` + ``bwd_dkv_call`` kernels against the GLOBAL
  logsumexp, their grads carried in f32 accumulators and cast back, as
  ``_ring_flash3_bwd`` does;
- ``ring_attention_local`` (JAX :35-108), the einsum streaming path the
  dispatcher takes where the flash contract rejects the local block:
  each K/V block streams through the online softmax in ``kv_chunk``
  chunks, each chunk recomputed in the backward (``checkpoint``), so the
  live scores are ``[b, n, s_local, kv_chunk]``.

Causal self-attention without dropout only, as in JAX; the model refuses
attention dropout on this path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from fleetx_tpu_torch.ops import flash_attention as FA
from fleetx_tpu_torch.ops.save_points import kept

__all__ = ["ring_attention", "ring_attention_local", "ring_flash_local",
           "flash_ring_supported", "merge_blocks"]

_NEG_INF = -1e30


def _check_ring(ring: int) -> None:
    if int(ring) != 1:
        raise NotImplementedError(
            f"ring attention over {ring} ranks rotates K/V between devices: "
            f"distributed training is not ported yet (ROADMAP.md, port "
            f"queue item 12)")


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kv_chunk: Optional[int] = None) -> torch.Tensor:
    """The einsum streaming path over the local block, q/k/v ``[b,
    s_local, n, d]``: exact softmax(QKᵀ)V rows, f32 scores and
    accumulators, out in q's dtype. ``kv_chunk`` must divide ``s_local``."""
    b, s_loc, n, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    chunk = int(kv_chunk) if kv_chunk else s_loc
    if s_loc % chunk:
        raise ValueError(f"kv_chunk {chunk} must divide the local block "
                         f"length {s_loc}")
    q32 = q.float()
    qpos = torch.arange(s_loc, device=q.device)  # this rank's block, me = 0

    def fold(m, l, o, k_c, v_c, kpos_c):
        """One K/V chunk through the streaming softmax update."""
        s = torch.einsum("bqnd,bknd->bnqk", q32, k_c.float()) \
            * scale.to(q.device)
        if causal:
            mask = kpos_c[None, :] <= qpos[:, None]
            s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        o_new = o * corr[..., None] + torch.einsum("bnqk,bknd->bnqd", p,
                                                   v_c.float())
        return m_new, l_new, o_new

    m = torch.full((b, n, s_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n, s_loc), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, n, s_loc, d), dtype=torch.float32, device=q.device)
    # ring step t = 0: this rank's own block, j = me = 0
    kpos = torch.arange(s_loc, device=q.device)
    for c in range(s_loc // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        # recompute each chunk in the backward (JAX remats the fold) so
        # the live scores stay one [b, n, s_local, chunk] block
        m, l, o = checkpoint(fold, m, l, o, k[:, sl], v[:, sl], kpos[sl],
                             use_reentrant=False)
    # TODO(item 12): ring steps t >= 1 rotate K/V to the next rank
    # (ppermute over torch.distributed) and fold block (me - t) % ring
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_ring_supported(q: torch.Tensor, ring: int) -> bool:
    """True when each rank's local block (seq / ``ring``) meets the flash
    kernels' contract."""
    if q.dim() != 4 or q.shape[1] % max(ring, 1):
        return False
    s_loc, d = q.shape[1] // ring, q.shape[3]
    return s_loc >= 128 and s_loc % 128 == 0 and d in (64, 128, 256)


def merge_blocks(o_acc: torch.Tensor, l_acc: torch.Tensor,
                 o_t: torch.Tensor, l_t: torch.Tensor):
    """Fold block ``t``'s ``(out, lse)`` into the running ``(out f32,
    lse)``: the online-logsumexp merge of ``_ring_flash_fwd_pass``."""
    l_new = torch.logaddexp(l_acc, l_t)
    o_new = (o_acc * torch.exp(l_acc - l_new)[..., None]
             + o_t.float() * torch.exp(l_t - l_new)[..., None])
    return o_new, l_new


class _RingFlash3(torch.autograd.Function):
    """Causal ring attention on ``[b·heads, s_local, head_dim]`` operands
    through the flash kernels."""

    @staticmethod
    def forward(ctx, q3, k3, v3):
        """The causal diagonal block (ring step 0) through the forward
        kernel's custom op (a save point of kind ``"kernel"``); ``(out,
        lse)`` is the merge's running state."""
        scale = q3.shape[-1] ** -0.5
        out, lse = kept("kernel", lambda: FA.flash_fwd(q3, k3, v3, 0, scale,
                                                       True, 0.0))
        out = out.float()
        # TODO(item 12): for t in 1..ring-1, rotate K/V (ppermute) and,
        # where block (me - t) % ring is visible (t <= me), run fwd_call
        # non-causal on it and fold it in with merge_blocks
        out = out.to(q3.dtype)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        """Split dq + dk/dv kernels against the GLOBAL logsumexp, grads
        accumulated in f32 and cast back to the operand dtypes."""
        q3, k3, v3, out, lse = ctx.saved_tensors
        scale = q3.shape[-1] ** -0.5
        g = g.contiguous()
        # p = exp(s - GLOBAL lse) makes each block's backward exact
        delta = (out.float() * g.float()).sum(dim=-1)
        args = (q3, k3, v3, g, lse, delta, 0, scale, True, 0.0)
        dq = FA.bwd_dq_call(*args).float()
        dk, dv = (t.float() for t in FA.bwd_dkv_call(*args))
        # TODO(item 12): the dk/dv accumulators travel with their K/V block
        # around the ring (ppermute), visible blocks run non-causal, and one
        # last hop brings them home
        return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def ring_flash_local(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal ring attention whose per-block math runs on the flash
    kernels; q/k/v ``[b, s_local, n, d]``."""
    b, s_loc, n, d = q.shape

    def to3(x):
        return x.transpose(1, 2).reshape(b * n, s_loc, d).contiguous()

    out3 = _RingFlash3.apply(to3(q), to3(k), to3(v))
    return out3.reshape(b, n, s_loc, d).transpose(1, 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, ring: int = 1,
                   kv_chunk: Optional[int] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel attention, q/k/v ``[b, s, n, d]`` over a ring of
    ``ring`` ranks (``Distributed.seq_degree``; only 1 is ported).
    ``use_flash`` None routes causal calls whose local block fits the
    flash contract through ``ring_flash_local``, the rest through the
    einsum path with ``kv_chunk``."""
    _check_ring(ring)
    if use_flash is None:
        use_flash = causal and flash_ring_supported(q, ring)
    if use_flash:
        return ring_flash_local(q, k, v)
    return ring_attention_local(q, k, v, causal=causal, kv_chunk=kv_chunk)
