"""Paged decode/prefill steps with static shapes (port of
``fleetx_tpu/serving/decode.py``).

Two step functions the continuous-batching scheduler calls every step:

- ``prefill``: one chunk of ONE request's prompt (``[1, prefill_chunk]``,
  ragged tail masked) is forwarded, its K/V scattered into the request's
  pages, and the last valid position's logits/sampled token returned;
- ``decode``: one token for EVERY slot of the static ``[max_batch]``
  batch; inactive slots point at the null page and are masked.

The forward is the JAX module's line for line over the raw parameter
dict (stacked ``[layers, ...]`` leaves): f32 layernorms, cfg-dtype
matmuls, f32 softmax, tanh-approximate GELU. ``lax.scan`` over layers is
a Python loop over the stacked leaves, and ``jit`` has no counterpart:
PyTorch runs eagerly (the step functions are plain callables).

Decode attention takes one of two paths, chosen ONCE per engine: the
hand-written CUDA page-walk kernel (``ops/paged_attention.py``), or the
gathered view ``pool[block_tables] → [B, pages_per_req·page_size, heads,
head_dim]`` when ``paged_kernel_enabled`` rejects the geometry. Prefill
always takes the gather (its queries span a whole chunk).

Quantized decode (``quantize``, ``ServingConfig.quantize_decode``):
int8-style fake-quant (``ops/quantization.py``) on the four matmuls of
every layer, as the JAX steps do: per-output-channel weights (``qkv``,
``out``, ``wi``, ``wo`` kernels, cast to the compute dtype first, with
``Model.qat_bits``) and per-tensor activations (the ln1 output before
``qkv``, the attention output before ``out``, the ln2 output before
``wi``, the GELU output before ``wo``, with ``Model.qat_act_bits``). An
activation's scale spans the whole step tensor: prefill's
``[1, prefill_chunk, h]`` chunk with its padded positions and decode's
``[max_batch, 1, h]`` batch with its inactive slots, the rows the JAX
steps put there, so a request's tokens depend on its neighbours exactly
as they do in JAX. A replica's weights are fixed, so ``prepare_params``
fake-quantizes them once (each layer over its own input dims, which is
the per-call quantization bit for bit) and the step functions quantize
only the activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt import generation as G
from fleetx_tpu_torch.ops import paged_attention as PA
from fleetx_tpu_torch.ops.quantization import fake_quant

#: parameter subtrees kept in their own dtype (the f32 layernorms)
_NORM_KEYS = ("ln1", "ln2", "ln_f")

#: the quantized kernels of a layer and the dims of their stacked
#: ``[layers, ...]`` leaf each scale reduces over (the input dims: one
#: scale per layer and output channel; the JAX steps' ``axis=0`` and
#: ``axis=(0, 1)`` on one layer's kernel)
QUANT_KERNELS = {("attn", "qkv_kernel"): (1,),
                 ("attn", "out_kernel"): (1, 2),
                 ("mlp", "wi_kernel"): (1,),
                 ("mlp", "wo_kernel"): (1,)}


def paged_kernel_enabled(cfg: Any, *, page_size: int,
                         pages_per_req: int) -> bool:
    """Static kernel-vs-gather decision for one engine's geometry."""
    return PA.paged_attention_supported(
        num_heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
        page_size=page_size, pages_per_req=pages_per_req, dtype=cfg.dtype)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Engine-wide sampling knobs."""

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0


def prepare_params(params: dict, cfg: Any,
                   device: Union[str, torch.device],
                   quantize: bool = False) -> dict:
    """Move the parameter dict to ``device`` and cast every matmul and
    embedding leaf to the compute dtype once (the JAX forward casts them
    on every call; the values are the same). LayerNorm leaves keep their
    dtype: the norms compute in f32 against them. With ``quantize`` the
    four layer kernels are fake-quantized per layer and output channel
    after the cast (``QUANT_KERNELS``), as the JAX steps quantize them on
    every call."""

    def walk(node: Any, norm: bool) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, norm or k in _NORM_KEYS)
                    for k, v in node.items()}
        node = node.to(device)
        return node if norm else node.to(cfg.dtype)

    out = walk(params, False)
    if quantize:
        layers = out["gpt"]["layers"]
        for (group, name), dims in QUANT_KERNELS.items():
            layers[group][name] = fake_quant(layers[group][name],
                                             cfg.qat_bits, axis=dims)
    return out


def _layer_norm(p: dict, x: torch.Tensor, cfg: Any) -> torch.Tensor:
    """f32 layernorm matching ``models/gpt/model.py:LayerNorm``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + cfg.layer_norm_epsilon)
    return (y * p["scale"] + p["bias"]).to(cfg.dtype)


def _paged_attention(q: torch.Tensor, kd: torch.Tensor, vd: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """Decode attention over the gathered page view.

    ``q`` ``[B, S, heads, hd]``, ``kd``/``vd`` ``[B, K, heads, hd]``,
    ``q_pos`` ``[B, S]`` absolute positions. Scores are computed and
    scaled in the compute dtype, every key slot past the query's position
    is masked to the dtype's min, and the softmax runs in f32.
    """
    hd = q.shape[-1]
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    scores = torch.einsum("bqnd,bknd->bnqk", q, kd) / \
        root.to(device=q.device, dtype=q.dtype)
    k_pos = torch.arange(kd.shape[1], device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, S, K]
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores,
                                         torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, vd)


def _forward(params: dict, cfg: Any, tokens: torch.Tensor,
             positions: torch.Tensor, pool_k: torch.Tensor,
             pool_v: torch.Tensor, block_tables: torch.Tensor,
             paged_kernel: bool = False, quantize: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward a ``[B, S]`` token block through the paged decode stack.

    Writes the block's K/V into the pools, then attends, per layer: the
    CUDA page-walk kernel when ``paged_kernel`` is set (decode only,
    ``S == 1``), the gathered page view otherwise. Returns ``(hidden
    [B, S, h], pool_k, pool_v)``. The pools are updated IN PLACE (the JAX
    steps donate them and return new buffers); the returned pools are the
    same tensors. Negative ``positions`` mark invalid slots, which write
    to the null page and are masked. ``quantize`` fake-quantizes the four
    matmul inputs per tensor; the kernels come quantized from
    ``prepare_params(..., quantize=True)``.
    """
    B, S = tokens.shape
    ps = pool_k.shape[2]
    gpt = params["gpt"]
    emb = gpt["embeddings"]
    tokens = tokens.long()
    positions = positions.long()
    block_tables = block_tables.long()

    wte = emb["word_embeddings"].to(cfg.dtype)
    wpe = emb["position_embeddings"].to(cfg.dtype)
    safe_pos = positions.clamp(0, cfg.max_position_embeddings - 1)
    x = wte[tokens] + wpe[safe_pos]

    # scatter targets, shared by every layer: page id + in-page offset per
    # (row, slot); negative positions → null page 0, offset 0. Duplicate
    # targets there are harmless: page 0 is never read unmasked
    page_slot = torch.div(positions, ps, rounding_mode="floor").clamp(
        0, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables, 1, page_slot)
    pages = torch.where(positions >= 0, pages, torch.zeros_like(pages))
    offs = torch.remainder(positions, ps).clamp(0, ps - 1)
    q_pos = positions.clamp(min=0)

    nh, hd, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    layers = gpt["layers"]

    def act(t: torch.Tensor) -> torch.Tensor:
        return fake_quant(t, cfg.qat_act_bits) if quantize else t

    x = x.to(cfg.dtype)
    for i in range(cfg.num_layers):
        attn_p, mlp_p = layers["attn"], layers["mlp"]
        residual = x
        y = act(_layer_norm({"scale": layers["ln1"]["scale"][i],
                             "bias": layers["ln1"]["bias"][i]}, x, cfg))
        qkv_k = attn_p["qkv_kernel"][i].to(cfg.dtype).reshape(h, 3 * nh * hd)
        qkv = (y.reshape(B * S, h) @ qkv_k).reshape(B, S, 3, nh, hd)
        qkv = qkv + attn_p["qkv_bias"][i].to(cfg.dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, S, nh, hd]

        # write before read: the query attends to its own position
        pk_l, pv_l = pool_k[i], pool_v[i]
        pk_l[pages, offs] = k
        pv_l[pages, offs] = v
        if paged_kernel and S == 1:
            # page walk in the kernel: the dense [B, pages_per_req·ps, nh,
            # hd] view is never materialised; positions[:, 0] < 0 marks
            # an inactive slot (all pages masked, exact-zero output)
            attn = PA.paged_attention(q[:, 0], pk_l, pv_l, block_tables,
                                      positions[:, 0])[:, None]
        else:
            kd = pk_l[block_tables].reshape(B, -1, nh, hd)
            vd = pv_l[block_tables].reshape(B, -1, nh, hd)
            attn = _paged_attention(q, kd, vd, q_pos)

        attn = act(attn)
        out_k = attn_p["out_kernel"][i].to(cfg.dtype).reshape(nh * hd, h)
        y = (attn.reshape(B * S, nh * hd) @ out_k).reshape(B, S, h)
        y = y + attn_p["out_bias"][i].to(cfg.dtype)
        x = residual + y

        residual = x
        y = act(_layer_norm({"scale": layers["ln2"]["scale"][i],
                             "bias": layers["ln2"]["bias"][i]}, x, cfg))
        y = y @ mlp_p["wi_kernel"][i].to(cfg.dtype) + \
            mlp_p["wi_bias"][i].to(cfg.dtype)
        y = act(torch.nn.functional.gelu(y, approximate="tanh"))
        y = y @ mlp_p["wo_kernel"][i].to(cfg.dtype) + \
            mlp_p["wo_bias"][i].to(cfg.dtype)
        x = residual + y

    x = _layer_norm(gpt["ln_f"], x, cfg)
    return x, pool_k, pool_v


def _logits(params: dict, cfg: Any, x_last: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head on the selected positions → f32 ``[B, V]``."""
    wte = params["gpt"]["embeddings"]["word_embeddings"].to(cfg.dtype)
    return (x_last @ wte.t()).float()


def _sample(logits: torch.Tensor, rng: Optional[torch.Generator],
            sp: SamplingParams) -> torch.Tensor:
    """Greedy argmax or the sampling-transform chain (temperature →
    top-k → top-p → categorical draw from ``rng``)."""
    if not sp.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = G.apply_temperature(logits, sp.temperature)
    l = G.apply_top_k(l, sp.top_k)
    l = G.apply_top_p(l, sp.top_p)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)


def make_step_fns(cfg: Any, *, prefill_chunk: int, sampling: SamplingParams,
                  paged_kernel: bool = False, quantize: bool = False) -> dict:
    """Build the two serving step functions for one engine.

    Returns ``{"prefill": fn, "decode": fn}``; host arrays (numpy) are
    copied to the pools' device on each call, and both return the pools
    (updated in place) plus the sampled tokens and f32 logits.
    Batch and table widths arrive with the arrays themselves.
    ``paged_kernel`` fixes the decode-attention path (callers gate on
    ``paged_kernel_enabled``; this function obeys, it doesn't decide).
    ``quantize`` runs both steps on fake-quantized activations (the params
    must come from ``prepare_params(..., quantize=True)``).
    """

    def dev(a: Any, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=device)

    @torch.inference_mode()
    def prefill(params, pool_k, pool_v, tokens, block_table, start, n_valid,
                rng):
        """One prompt chunk for one request: ``tokens`` ``[1, C]`` with
        ``n_valid`` real entries starting at absolute position ``start``;
        returns the pools plus the last valid position's sampled token and
        f32 logits (meaningful on the request's final chunk)."""
        d = pool_k.device
        idx = torch.arange(prefill_chunk, device=d)[None, :]
        positions = torch.where(idx < int(n_valid), int(start) + idx,
                                torch.full_like(idx, -1))
        x, pool_k, pool_v = _forward(params, cfg, dev(tokens, d), positions,
                                     pool_k, pool_v, dev(block_table, d),
                                     quantize=quantize)
        last = min(max(int(n_valid) - 1, 0), prefill_chunk - 1)
        logits = _logits(params, cfg, x[0, last][None])
        return pool_k, pool_v, _sample(logits, rng, sampling), logits

    @torch.inference_mode()
    def decode(params, pool_k, pool_v, tokens, block_tables, lens, rng):
        """One decode step for the full static batch: ``tokens``/``lens``
        ``[max_batch]`` (inactive slots carry ``lens < 0`` and null-page
        block tables); returns pools + sampled tokens + f32 logits."""
        d = pool_k.device
        lens_t = dev(lens, d)
        positions = torch.where(lens_t >= 0, lens_t,
                                torch.full_like(lens_t, -1))[:, None]
        x, pool_k, pool_v = _forward(
            params, cfg, dev(tokens, d)[:, None], positions, pool_k, pool_v,
            dev(block_tables, d), paged_kernel=paged_kernel,
            quantize=quantize)
        logits = _logits(params, cfg, x[:, 0])
        return pool_k, pool_v, _sample(logits, rng, sampling), logits

    return {"prefill": prefill, "decode": decode}
