"""ERNIE (BERT-style) encoder with the MLM and NSP pretraining heads.

Port of ``fleetx_tpu/models/ernie/model.py``: ``ErnieConfig`` (:27-53),
``ErnieLayerNorm``, ``ErnieSelfAttention``, ``ErnieEncoderLayer``,
``ErnieModel``, ``ErnieForPretraining`` (:59-258), ``IGNORE_INDEX`` and
``pretraining_criterion`` (:261-278) and ``config_from_dict`` (:281-290).

Parameters are a nested dict of tensors shaped like the flax pytree with
``scan_layers`` (the layer leaves stacked on a leading ``[num_layers]``
dim under ``ernie/layers``; ``qkv_kernel [h, 3, nh, hd]``, ``out_kernel
[nh, hd, h]``), so converted JAX weights (``convert.ernie_params_from_jax``)
and the port's seeded init are interchangeable. The forward is plain
functions over that dict, in the JAX module's cast points: weights cast to
the compute dtype at use, a compute-dtype residual stream, f32 LayerNorm,
the padding-masked scores set to the compute dtype's ``finfo.min`` before
an f32 softmax (a row whose keys are all masked comes out uniform), the
tanh-approximate GELU, and the MLM decoder tied to
``ernie/word_embeddings`` (one tensor, so both uses' grads land on it).

Attention and the LayerNorms are plain PyTorch, as they are plain ``jnp``
in JAX: no hand-written kernel is on this path. ``use_recompute``
recomputes each layer in the backward (``nothing_saveable``), through
``models/gpt/model.recompute``'s generator replay so a recomputed layer
draws the forward's dropout masks. ``scan_layers`` is an XLA compile knob
that nothing here reads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from fleetx_tpu_torch.models.gpt.model import (
    DTYPES, DropoutRng, _dropout, _unstack, f32_layer_norm, recompute)
from fleetx_tpu_torch.parallel import sharding as SH
from fleetx_tpu_torch.parallel.mesh import psum_axes

#: unmasked-position sentinel in ``mlm_labels`` (the datasets' convention)
IGNORE_INDEX = -100


@dataclasses.dataclass
class ErnieConfig:
    """Architecture config (the YAML ``Model:`` section)."""

    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    scan_layers: bool = True
    use_recompute: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def config_from_dict(d: dict) -> ErnieConfig:
    """An ``ErnieConfig`` from a YAML ``Model:`` section; unknown keys are
    ignored, as the JAX loader ignores them."""
    known = {f.name for f in dataclasses.fields(ErnieConfig)}
    kwargs = {k: v for k, v in d.items() if k in known and v is not None}
    for key in ("dtype", "param_dtype"):
        if isinstance(kwargs.get(key), str):
            kwargs[key] = DTYPES[kwargs[key]]
    return ErnieConfig(**kwargs)


def param_shapes(cfg: ErnieConfig) -> dict:
    """The parameter tree's leaf shapes, in the flax pytree's nesting."""
    L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim
    nh, hd, v = cfg.num_attention_heads, cfg.head_dim, cfg.vocab_size

    def ln(*lead):
        return {"scale": (*lead, h), "bias": (*lead, h)}

    return {
        "ernie": {
            "word_embeddings": (v, h),
            "position_embeddings": (cfg.max_position_embeddings, h),
            "token_type_embeddings": (cfg.type_vocab_size, h),
            "embed_ln": ln(),
            "layers": {
                "attn": {"qkv_kernel": (L, h, 3, nh, hd),
                         "qkv_bias": (L, 3, nh, hd),
                         "out_kernel": (L, nh, hd, h),
                         "out_bias": (L, h)},
                "ln1": ln(L),
                "wi_kernel": (L, h, f), "wi_bias": (L, f),
                "wo_kernel": (L, f, h), "wo_bias": (L, h),
                "ln2": ln(L),
            },
            "pooler_kernel": (h, h), "pooler_bias": (h,),
        },
        "mlm_transform_kernel": (h, h), "mlm_transform_bias": (h,),
        "mlm_ln": ln(),
        "mlm_bias": (v,),
        "nsp_kernel": (h, 2), "nsp_bias": (2,),
    }


def init_params(cfg: ErnieConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> dict:
    """Seeded init in the JAX layout on ``device``: kernels and embeddings
    N(0, ``initializer_range``), biases 0, LayerNorm scales 1 (the JAX
    init's distributions, not its bits)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(node: Any, path: tuple) -> Any:
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        if name.endswith("_kernel") or name.endswith("_embeddings"):
            out = torch.empty(node, dtype=cfg.param_dtype, device=device)
            return out.normal_(0.0, cfg.initializer_range, generator=gen)
        fill = 1.0 if name == "scale" else 0.0
        return torch.full(node, fill, dtype=cfg.param_dtype, device=device)

    return build(param_shapes(cfg), ())


def _ln(p: dict, x: torch.Tensor, cfg: ErnieConfig) -> torch.Tensor:
    """``ErnieLayerNorm``: f32 statistics, the result in the compute
    dtype."""
    return f32_layer_norm(x, p["scale"], p["bias"], cfg.layer_norm_epsilon,
                          cfg.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return x @ w.to(dtype) + b.to(dtype)


def self_attention(p: dict, x: torch.Tensor, cfg: ErnieConfig,
                   attention_mask: Optional[torch.Tensor], *,
                   deterministic: bool,
                   rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ErnieSelfAttention``: bidirectional attention over ``[b, s, h]``;
    keys where ``attention_mask`` is 0 score the compute dtype's
    ``finfo.min``."""
    b, s, h = x.shape
    nh, hd, dtype = cfg.num_attention_heads, cfg.head_dim, cfg.dtype
    x = x.to(dtype)
    qkv = (x @ p["qkv_kernel"].to(dtype).reshape(h, 3 * nh * hd)).reshape(
        b, s, 3, nh, hd) + p["qkv_bias"].to(dtype)
    q, k, v = qkv.unbind(2)
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(
        device=x.device, dtype=dtype)
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / root
    if attention_mask is not None:
        key_mask = attention_mask.bool()[:, None, None, :]
        scores = torch.where(key_mask, scores, torch.full_like(
            scores, torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if cfg.attention_probs_dropout_prob > 0.0 and not deterministic:
        probs = _dropout(probs, cfg.attention_probs_dropout_prob, rng)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, nh * hd)
    return _dense(out, p["out_kernel"].reshape(nh * hd, h), p["out_bias"],
                  dtype)


def encoder_layer(p: dict, x: torch.Tensor, cfg: ErnieConfig,
                  attention_mask: Optional[torch.Tensor], *,
                  deterministic: bool,
                  rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ErnieEncoderLayer``: post-LN attention and FFN blocks."""
    drop = cfg.hidden_dropout_prob > 0.0 and not deterministic
    y = self_attention(p["attn"], x, cfg, attention_mask,
                       deterministic=deterministic, rng=rng)
    if drop:
        y = _dropout(y, cfg.hidden_dropout_prob, rng)
    x = _ln(p["ln1"], x + y, cfg)
    y = F.gelu(_dense(x.to(cfg.dtype), p["wi_kernel"], p["wi_bias"],
                      cfg.dtype), approximate="tanh")
    y = _dense(y, p["wo_kernel"], p["wo_bias"], cfg.dtype)
    if drop:
        y = _dropout(y, cfg.hidden_dropout_prob, rng)
    return _ln(p["ln2"], x + y, cfg)


def ernie_model(params: dict, cfg: ErnieConfig, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[DropoutRng] = None) -> tuple:
    """``ErnieModel``: embeddings, the encoder stack and the pooler;
    ``(hidden [b, s, h], pooled [b, h])`` in the compute dtype."""
    p, dtype = params["ernie"], cfg.dtype
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    if position_ids is None:
        position_ids = torch.arange(
            input_ids.shape[1], device=input_ids.device).expand(
                input_ids.shape)
    x = (F.embedding(input_ids, p["word_embeddings"].to(dtype))
         + F.embedding(position_ids, p["position_embeddings"].to(dtype))
         + F.embedding(token_type_ids, p["token_type_embeddings"].to(dtype)))
    x = _ln(p["embed_ln"], x, cfg)
    if cfg.hidden_dropout_prob > 0.0 and not deterministic:
        x = _dropout(x, cfg.hidden_dropout_prob, rng)
    for lp in _unstack(p["layers"], cfg.num_layers):
        layer = functools.partial(encoder_layer, lp, cfg=cfg,
                                  attention_mask=attention_mask,
                                  deterministic=deterministic, rng=rng)
        x = recompute(layer, rng, x) if cfg.use_recompute else layer(x)
    pooled = torch.tanh(_dense(x[:, 0], p["pooler_kernel"], p["pooler_bias"],
                               dtype))
    return x, pooled


def ernie_for_pretraining(params: dict, cfg: ErnieConfig,
                          input_ids: torch.Tensor,
                          token_type_ids: Optional[torch.Tensor] = None,
                          position_ids: Optional[torch.Tensor] = None,
                          attention_mask: Optional[torch.Tensor] = None, *,
                          deterministic: bool = True,
                          rng: Optional[DropoutRng] = None) -> tuple:
    """``ErnieForPretraining``: ``(mlm_logits [b, s, vocab], nsp_logits
    [b, 2])`` in the compute dtype; the MLM decoder is the word embedding
    table."""
    dtype = cfg.dtype
    hidden, pooled = ernie_model(params, cfg, input_ids, token_type_ids,
                                 position_ids, attention_mask,
                                 deterministic=deterministic, rng=rng)
    h = F.gelu(_dense(hidden, params["mlm_transform_kernel"],
                      params["mlm_transform_bias"], dtype),
               approximate="tanh")
    h = _ln(params["mlm_ln"], h, cfg)
    wte = params["ernie"]["word_embeddings"].to(dtype)
    mlm_logits = torch.einsum("bsh,vh->bsv", h, wte) + \
        params["mlm_bias"].to(dtype)
    nsp_logits = _dense(pooled, params["nsp_kernel"], params["nsp_bias"],
                        dtype)
    return mlm_logits, nsp_logits


def pretraining_criterion(mlm_logits: torch.Tensor, nsp_logits: torch.Tensor,
                          mlm_labels: torch.Tensor,
                          nsp_labels: Optional[torch.Tensor] = None,
                          shard=None) -> tuple:
    """``(loss, mlm_loss, nsp_loss)``: the f32 MLM cross entropy over the
    labelled positions (``mlm_labels != IGNORE_INDEX``), plus the NSP
    cross entropy when ``nsp_labels`` is given (else ``nsp_loss`` is 0).
    On a mesh (``shard``, data parallel) both are the global batch's: the
    MLM sum and count psum'd over the data ranks, the NSP mean over
    them (``sharding.data_mean``)."""
    logits = mlm_logits.float()
    mask = mlm_labels != IGNORE_INDEX
    safe = torch.where(mask, mlm_labels, torch.zeros_like(mlm_labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    mlm_losses = (logz - picked) * mask.float()
    num, den = mlm_losses.sum(), mask.sum()
    if shard is not None:
        num = SH.global_sum(num, shard.mesh)
        den = psum_axes(den, SH.DATA_AXES, shard.mesh)
    mlm_loss = num / torch.clamp(den, min=1)
    if nsp_labels is None:
        return mlm_loss, mlm_loss, torch.zeros((), device=logits.device)
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = SH.data_mean(-torch.gather(
        nsp_logp, -1, nsp_labels.long()[:, None]).mean(), shard)
    return mlm_loss + nsp_loss, mlm_loss, nsp_loss
