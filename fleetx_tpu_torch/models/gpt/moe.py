"""Mixture-of-Experts FFN (port of ``fleetx_tpu/models/gpt/moe.py:33-111``).

GShard/Switch top-k routing with a capacity per expert, as ``MoEMlp``
computes it: an f32 router and softmax; the top ``k`` experts of each
token (ties to the lower expert index, as ``jax.lax.top_k`` orders them)
with their gates renormalised by ``max(sum, 1e-9)``; the capacity
``C = int(max(1, ceil(cf · k · t / E)))`` from the ``t`` tokens of the
call (a micro-batch in training, ``b × prompt`` at prefill, ``b`` at a
decode step); GShard priority (every first choice queues before any
second choice, slots from a running count over the choice-major
``[k·t, E]`` one-hot); token-choices at or past capacity dropped, the
gates not renormalised after the drop. Each expert is
``gelu_tanh(x @ wi + bi) @ wo + bo`` in the compute dtype, and a token's
output is the sum of its kept choices' outputs times their gates rounded
to the compute dtype. The Switch load-balance loss ``E · Σ_e f_e · P_e``
(``f_e`` the share of first choices, without a gradient; ``P_e`` the mean
router probability) comes back times ``moe_aux_weight``.

``moe_mlp`` dispatches by index: each kept token-choice's row is copied
into its ``[E, C, h]`` slot, the experts run as two batched matmuls over
every slot (empty slots hold zeros, as in JAX), and each token gathers
back its kept rows times their gates. It is the same function as JAX's
one-hot einsums
(the dispatch one-hot selects exactly one row per slot, and a token's
combine sums at most ``k`` terms) without the dense ``[t, E, C]``
dispatch and combine tensors, which at a 345M micro-batch (t 8192, C
2560) are 671 MB each in f32 a layer. ``moe_mlp_plain`` keeps JAX's
literal einsums; the tests hold the two against each other and against
JAX. The combine sums in f32 and rounds once to the compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens, as JAX writes it:
    ``int(max(1, -(-cf * k * t // E)))``."""
    return int(max(1, -(-cfg.moe_capacity_factor * cfg.moe_top_k * tokens
                        // cfg.moe_num_experts)))


@dataclasses.dataclass
class Routing:
    """One call's routing of ``t`` tokens over ``E`` experts."""

    probs: torch.Tensor      # [t, E] f32 router softmax
    gates: torch.Tensor      # [t, k] f32, renormalised over the k chosen
    experts: torch.Tensor    # [t, k] int64, best first, ties to low index
    slots: torch.Tensor      # [t, k] int64 queue position at its expert
    keep: torch.Tensor       # [t, k] bool, slot below capacity
    capacity: int

    @property
    def dropped_share(self) -> torch.Tensor:
        """Share of token-choices past capacity (0-d f32)."""
        return 1.0 - self.keep.float().mean()


def route(router_kernel: torch.Tensor, x_flat: torch.Tensor,
          cfg) -> Routing:
    """The f32 router, the top-k, the capacity and GShard priority for
    ``x_flat [t, h]``."""
    t = x_flat.shape[0]
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    logits = x_flat.float() @ router_kernel.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower index first among equal
    # probabilities, as jax.lax.top_k does (torch.topk promises no order)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, t)
    # choice-major rows: every first choice queues before any second; the
    # running count per expert runs along the last axis of the [E, k·t]
    # one-hot (a scan along the outer axis is one thread per column)
    flat = idx.t().reshape(k * t)
    onehot = F.one_hot(flat, E).t().contiguous()
    before = torch.cumsum(onehot, dim=1) - onehot
    slots = before.gather(0, flat[None, :])[0].reshape(k, t).t()
    return Routing(probs, gates, idx, slots, slots < cap, cap)


def load_balance_loss(r: Routing, cfg) -> torch.Tensor:
    """``moe_aux_weight · E · Σ_e f_e · P_e`` (f32)."""
    E, t = cfg.moe_num_experts, r.probs.shape[0]
    f_e = torch.bincount(r.experts[:, 0], minlength=E).float() / t
    p_e = r.probs.mean(dim=0)
    return cfg.moe_aux_weight * (E * torch.sum(f_e * p_e))


def _experts(p: dict, expert_in: torch.Tensor, dtype) -> torch.Tensor:
    """``gelu_tanh(x_e @ wi + bi) @ wo + bo`` over ``[E, C, h]`` slots."""
    h1 = torch.bmm(expert_in, p["wi_kernel"].to(dtype)) \
        + p["wi_bias"].to(dtype)[:, None, :]
    h1 = F.gelu(h1, approximate="tanh")
    return torch.bmm(h1, p["wo_kernel"].to(dtype)) \
        + p["wo_bias"].to(dtype)[:, None, :]


def moe_mlp(p: dict, x: torch.Tensor, cfg):
    """``MoEMlp`` on ``x [b, s, h]``: ``(y [b, s, h], aux)``, dispatched
    by index (module docstring). Every token-choice has a destination row:
    its slot ``e·C + slot`` when kept, else a scratch row ``E·C`` that is
    cut off after the copy and holds zeros for the gather back; so the
    only rows a backward accumulates into from many choices are the
    scratch row's, and no step waits on the host for a count."""
    b, s, h = x.shape
    t, E, k = b * s, cfg.moe_num_experts, cfg.moe_top_k
    dtype = cfg.dtype
    x_flat = x.reshape(t, h)
    r = route(p["router_kernel"], x_flat, cfg)
    C = r.capacity
    dest = torch.where(r.keep, r.experts * C + r.slots,
                       torch.full_like(r.slots, E * C)).reshape(t * k)
    rows = x_flat.to(dtype).repeat_interleave(k, dim=0)    # token-major
    expert_in = rows.new_zeros(E * C + 1, h).index_copy(0, dest, rows)
    out_e = _experts(p, expert_in[:E * C].reshape(E, C, h), dtype)
    out = F.pad(out_e.reshape(E * C, h), (0, 0, 0, 1)).index_select(0, dest)
    # the gates rounded to the compute dtype (JAX casts combine), the sum
    # over a token's k choices in f32 (dropped ones weigh 0), one rounding
    w = (r.gates * r.keep).to(dtype).float().reshape(t * k, 1)
    y = (out.float() * w).reshape(t, k, h).sum(dim=1).to(dtype)
    return y.reshape(b, s, h), load_balance_loss(r, cfg)


def moe_mlp_plain(p: dict, x: torch.Tensor, cfg):
    """JAX's literal computation: the dense ``[t, E, C]`` dispatch and
    combine one-hots and their einsums (for the tests)."""
    b, s, h = x.shape
    t, E, k = b * s, cfg.moe_num_experts, cfg.moe_top_k
    dtype = cfg.dtype
    x_flat = x.reshape(t, h)
    r = route(p["router_kernel"], x_flat, cfg)
    C = r.capacity
    onehot = F.one_hot(r.experts, E).float()                  # [t, k, E]
    flat = onehot.transpose(0, 1).reshape(k * t, E)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = torch.einsum("fe,fe->f", pos, flat)
    pos = pos.reshape(k, t).t().to(torch.int32)
    keep = pos < C
    slot = F.one_hot(torch.where(keep, pos, C).long(), C + 1)[..., :C]
    slot = slot.float() * keep[..., None]
    dispatch = torch.einsum("tke,tkc->tec", onehot, slot)
    combine = torch.einsum("tke,tkc,tk->tec", onehot, slot, r.gates)
    expert_in = torch.einsum("tec,th->ech", dispatch.to(dtype),
                             x_flat.to(dtype))
    out_e = _experts(p, expert_in, dtype)
    y = torch.einsum("tec,ech->th", combine.to(dtype), out_e)
    return y.reshape(b, s, h), load_balance_loss(r, cfg)
