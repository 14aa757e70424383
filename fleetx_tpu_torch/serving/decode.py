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

On a mesh (``mesh``, ``parallel/mesh.py``) each rank holds its slice of
the weights (``shard_params``, the ``gpt`` partition rules) and of the
pool (pages over ``fsdp``, heads over ``tensor``), and the forward is
Megatron's over the ``tensor`` axis: the qkv projection split by heads,
the out projection and ``wo`` row-parallel (a ``psum`` over ``tensor``,
the bias added once after it), ``wi`` column-parallel, the embedding
lookup and the tied LM head vocab-parallel (the logits all-gathered to
the full vocabulary before sampling). Over ``fsdp`` the K/V scatter
writes only the pages this shard owns; decode attention runs
``paged_attention_sharded`` (kernel row 7 on the local pages, then the
cross-shard combine), and the gather path rebuilds the dense view with a
``psum`` of each shard's own pages (one owner per page, so it is the
one-rank gather bit for bit). The per-tensor activation scales of a
head- or mlp-sharded tensor take a ``pmax`` over ``tensor``, the global
abs-max GSPMD computes in JAX. The ``data`` axis replicates: its ranks
compute the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt import generation as G
from fleetx_tpu_torch.ops import paged_attention as PA
from fleetx_tpu_torch.ops.quantization import fake_quant
from fleetx_tpu_torch.parallel import mesh as M
from fleetx_tpu_torch.parallel.rules import block_range, shard_tree

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


#: called with layer 0's attention output ``[B, 1, heads, hd]`` of the
#: next decode step, once, then cleared (``tap_next_decode``)
_decode_tap: Optional[Callable] = None


def tap_next_decode(fn: Optional[Callable]) -> None:
    """Hand layer 0's attention output of the next decode step (this
    rank's heads) to ``fn``, once: a diagnostic that holds a mesh
    replica's cross-shard combine against a one-rank engine."""
    global _decode_tap
    _decode_tap = fn


def paged_kernel_enabled(cfg: Any, *, page_size: int, pages_per_req: int,
                         num_pages: int = 0,
                         pool_sharding: Optional[Any] = None) -> bool:
    """Static kernel-vs-gather decision for one engine's geometry: the
    kernel takes the shape and, under a mesh that shards the pool, the
    per-shard call applies (``paged_sharded_supported``)."""
    if not PA.paged_attention_supported(
            num_heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
            page_size=page_size, pages_per_req=pages_per_req,
            dtype=cfg.dtype):
        return False
    if pool_sharding is not None:
        mesh = pool_sharding.mesh
        sharded = any(mesh.shape.get(a, 1) > 1 for a in ("fsdp", "tensor"))
        if sharded and not PA.paged_sharded_supported(
                mesh, num_heads=cfg.num_attention_heads,
                num_pages=num_pages):
            return False
    return True


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


def shard_params(params: dict, cfg: Any, mesh: Any,
                 layout: Optional[Any] = None) -> dict:
    """This rank's serving slice of a full GPT parameter dict
    (``parallel/rules.shard_tree``): every leaf whose ``gpt`` rule puts a
    dim on ``tensor`` is cut to this rank's contiguous block of it; an
    ``fsdp`` entry keeps its dim whole. On a mesh the params must be the
    full ``param_shapes(cfg)`` tree (``convert.check_tree``), or this
    raises ``ValueError``: a checkpoint of another model, or one already
    sliced, is refused before anything is cut."""
    if mesh is None:
        return params
    from fleetx_tpu_torch.convert import check_tree

    check_tree(params, cfg)
    if mesh.shape.get("tensor", 1) == 1:
        return params
    return shard_tree(params, mesh, layout)


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


def _tensor_size(mesh: Optional[Any]) -> int:
    return 1 if mesh is None else mesh.shape.get("tensor", 1)


def _embed(wte: torch.Tensor, tokens: torch.Tensor, cfg: Any,
           mesh: Optional[Any]) -> torch.Tensor:
    """The word-embedding lookup; vocab-parallel over ``tensor``: each
    rank looks up the ids of its block of rows, zeros for the rest, and a
    ``psum`` assembles the rows (one owner each: exact)."""
    t = _tensor_size(mesh)
    if t == 1:
        return wte[tokens]
    lo, hi = block_range(cfg.vocab_size, t, M.axis_index("tensor", mesh))
    local = tokens - lo
    own = (local >= 0) & (local < hi - lo)
    rows = wte[local.clamp(0, hi - lo - 1)]
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return M.psum(rows, "tensor", mesh)


def _forward(params: dict, cfg: Any, tokens: torch.Tensor,
             positions: torch.Tensor, pool_k: torch.Tensor,
             pool_v: torch.Tensor, block_tables: torch.Tensor,
             paged_kernel: bool = False, quantize: bool = False,
             mesh: Optional[Any] = None
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
    ``prepare_params(..., quantize=True)``. Under ``mesh`` the params and
    pools are this rank's slices (module docstring).
    """
    global _decode_tap
    B, S = tokens.shape
    ps = pool_k.shape[2]
    gpt = params["gpt"]
    emb = gpt["embeddings"]
    tokens = tokens.long()
    positions = positions.long()
    block_tables = block_tables.long()
    t = _tensor_size(mesh)
    fsdp = 1 if mesh is None else mesh.shape.get("fsdp", 1)

    wte = emb["word_embeddings"].to(cfg.dtype)
    wpe = emb["position_embeddings"].to(cfg.dtype)
    safe_pos = positions.clamp(0, cfg.max_position_embeddings - 1)
    x = _embed(wte, tokens, cfg, mesh) + wpe[safe_pos]

    # scatter targets, shared by every layer: page id + in-page offset per
    # (row, slot); negative positions → null page 0, offset 0. Duplicate
    # targets there are harmless: page 0 is never read unmasked
    page_slot = torch.div(positions, ps, rounding_mode="floor").clamp(
        0, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables, 1, page_slot)
    pages = torch.where(positions >= 0, pages, torch.zeros_like(pages))
    offs = torch.remainder(positions, ps).clamp(0, ps - 1)
    q_pos = positions.clamp(min=0)
    rows = None
    if fsdp > 1:
        # this shard owns pages [lo, lo + local): it writes those rows
        # only, at their local ids (a foreign id never aliases a local one)
        local_pages = pool_k.shape[1]
        lo = M.axis_index("fsdp", mesh) * local_pages
        local = pages - lo
        rows = ((local >= 0) & (local < local_pages)).nonzero(as_tuple=True)
        pages = local[rows]
        offs = offs[rows]
        table_local = block_tables - lo
        table_own = (table_local >= 0) & (table_local < local_pages)
        table_local = table_local.clamp(0, local_pages - 1)

    nh, hd, h = pool_k.shape[3], cfg.head_dim, cfg.hidden_size
    layers = gpt["layers"]

    def act(y: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        if not quantize:
            return y
        if sharded and t > 1:
            # the whole tensor's abs-max, as GSPMD reduces it in JAX
            amax = M.pmax(y.detach().abs().amax(), "tensor", mesh)
            return fake_quant(y, cfg.qat_act_bits, amax=amax)
        return fake_quant(y, cfg.qat_act_bits)

    def row_parallel(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return M.psum(y, "tensor", mesh) + bias

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
        if rows is None:
            pk_l[pages, offs] = k
            pv_l[pages, offs] = v
        else:
            pk_l[pages, offs] = k[rows]
            pv_l[pages, offs] = v[rows]
        if paged_kernel and S == 1:
            # page walk in the kernel: the dense [B, pages_per_req·ps, nh,
            # hd] view is never materialised; positions[:, 0] < 0 marks
            # an inactive slot (all pages masked, exact-zero output)
            attn = PA.paged_attention_sharded(
                q[:, 0], pk_l, pv_l, block_tables, positions[:, 0],
                mesh=mesh)[:, None]
        else:
            if rows is None:
                kd, vd = pk_l[block_tables], pv_l[block_tables]
            else:
                # each shard gathers the pages it owns, zeros for the
                # rest; one psum of K and V rebuilds the dense view
                own = table_own[..., None, None, None]
                kv = torch.stack([pk_l[table_local], pv_l[table_local]])
                kv = M.psum(torch.where(own, kv, torch.zeros_like(kv)),
                            "fsdp", mesh)
                kd, vd = kv[0], kv[1]
            attn = _paged_attention(q, kd.reshape(B, -1, nh, hd),
                                    vd.reshape(B, -1, nh, hd), q_pos)
        if i == 0 and S == 1 and _decode_tap is not None:
            tap, _decode_tap = _decode_tap, None
            tap(attn)

        attn = act(attn, sharded=True)
        out_k = attn_p["out_kernel"][i].to(cfg.dtype).reshape(nh * hd, h)
        y = (attn.reshape(B * S, nh * hd) @ out_k).reshape(B, S, h)
        x = residual + row_parallel(y, attn_p["out_bias"][i].to(cfg.dtype))

        residual = x
        y = act(_layer_norm({"scale": layers["ln2"]["scale"][i],
                             "bias": layers["ln2"]["bias"][i]}, x, cfg))
        y = y @ mlp_p["wi_kernel"][i].to(cfg.dtype) + \
            mlp_p["wi_bias"][i].to(cfg.dtype)
        y = act(torch.nn.functional.gelu(y, approximate="tanh"),
                sharded=True)
        y = y @ mlp_p["wo_kernel"][i].to(cfg.dtype)
        x = residual + row_parallel(y, mlp_p["wo_bias"][i].to(cfg.dtype))

    x = _layer_norm(gpt["ln_f"], x, cfg)
    return x, pool_k, pool_v


def _logits(params: dict, cfg: Any, x_last: torch.Tensor,
            mesh: Optional[Any] = None) -> torch.Tensor:
    """Tied-embedding LM head on the selected positions → f32 ``[B, V]``;
    vocab-parallel over ``tensor``: each rank's block of the vocabulary,
    all-gathered (blocks padded to one size, the padding cut off)."""
    wte = params["gpt"]["embeddings"]["word_embeddings"].to(cfg.dtype)
    logits = (x_last @ wte.t()).float()
    t = _tensor_size(mesh)
    if t == 1:
        return logits
    step = -(-cfg.vocab_size // t)
    pad = step - logits.shape[-1]
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad))
    return M.all_gather(logits, "tensor", mesh, dim=-1)[
        ..., :cfg.vocab_size]


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
                  paged_kernel: bool = False, quantize: bool = False,
                  mesh: Optional[Any] = None) -> dict:
    """Build the two serving step functions for one engine.

    Returns ``{"prefill": fn, "decode": fn}``; host arrays (numpy) are
    copied to the pools' device on each call, and both return the pools
    (updated in place) plus the sampled tokens and f32 logits.
    Batch and table widths arrive with the arrays themselves.
    ``paged_kernel`` fixes the decode-attention path (callers gate on
    ``paged_kernel_enabled``; this function obeys, it doesn't decide).
    ``quantize`` runs both steps on fake-quantized activations (the params
    must come from ``prepare_params(..., quantize=True)``). ``mesh`` runs
    them on this rank's slices of the params and pools; every rank of the
    mesh must call the same step with the same arguments.
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
                                     quantize=quantize, mesh=mesh)
        last = min(max(int(n_valid) - 1, 0), prefill_chunk - 1)
        logits = _logits(params, cfg, x[0, last][None], mesh)
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
            quantize=quantize, mesh=mesh)
        logits = _logits(params, cfg, x[:, 0], mesh)
        return pool_k, pool_v, _sample(logits, rng, sampling), logits

    return {"prefill": prefill, "decode": decode}
