"""Vision Transformer classifier.

Port of ``fleetx_tpu/models/vision/vit.py``: ``ViTConfig`` (:27-57),
``DropPath``, ``ViTAttention``, ``ViTMlp``, ``ViTLayerNorm``, ``ViTBlock``
and ``ViT`` (:64-267), ``PRESETS`` and ``config_from_dict`` (:272-292).

Parameters are a nested dict shaped like the flax pytree with
``scan_layers`` (the block leaves stacked on a leading ``[num_layers]``
dim under ``blocks``; ``patch_kernel`` HWIO ``[p, p, c, h]``), so
converted JAX weights (``convert.vit_params_from_jax``) and the seeded
init are interchangeable. Images are NHWC, as in JAX. The patch embedding
is the JAX stride-``p`` convolution written as one matmul: each image is
cut into ``(h/p) x (w/p)`` patches in row-major order, each patch
flattened as ``(row, col, channel)``, the order in which the HWIO kernel
reshapes to ``[p·p·c, h]``. The encoder is pre-norm with ``DropPath``
(one Bernoulli per sample, kept rows scaled by ``1 / keep``) on both
residual branches; the head reads the class token after ``ln_f``.

The inits have the JAX init's distributions, not its bits: a
xavier-uniform patch kernel (fan over the HWIO receptive field),
truncated-normal (±2 std) matmul kernels and ``pos_embed``, a zero
``cls_token``, and a zero head, so every logit is equal at init.
Attention and the LayerNorms are plain PyTorch, as they are plain
``jnp`` in JAX: no hand-written kernel is on this path. ``use_recompute``
recomputes each block in the backward through
``models/gpt/model.recompute`` (its generator replay reproduces the
dropout and DropPath draws).
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


@dataclasses.dataclass
class ViTConfig:
    """Architecture config (the reference ViT factory's keyword
    arguments)."""

    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_epsilon: float = 1e-6
    representation_size: Optional[int] = None
    scan_layers: bool = True
    use_recompute: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


PRESETS = {
    "ViT_tiny_patch16_224": dict(patch_size=16, hidden_size=192, num_layers=12,
                                 num_attention_heads=3),
    "ViT_small_patch16_224": dict(patch_size=16, hidden_size=384, num_layers=12,
                                  num_attention_heads=6),
    "ViT_base_patch16_224": dict(patch_size=16, hidden_size=768, num_layers=12,
                                 num_attention_heads=12),
    "ViT_base_patch16_384": dict(image_size=384, patch_size=16, hidden_size=768,
                                 num_layers=12, num_attention_heads=12),
    "ViT_large_patch16_224": dict(patch_size=16, hidden_size=1024, num_layers=24,
                                  num_attention_heads=16),
    "ViT_huge_patch14_224": dict(patch_size=14, hidden_size=1280, num_layers=32,
                                 num_attention_heads=16),
    "ViT_g_patch14_224": dict(patch_size=14, hidden_size=1408, num_layers=40,
                              num_attention_heads=16, mlp_ratio=4.364),
    "ViT_G_patch14_224": dict(patch_size=14, hidden_size=1664, num_layers=48,
                              num_attention_heads=16, mlp_ratio=4.9231),
    "ViT_6B_patch14_224": dict(patch_size=14, hidden_size=2320, num_layers=80,
                               num_attention_heads=16, mlp_ratio=4.9569),
}


def config_from_dict(d: dict) -> ViTConfig:
    """A ``ViTConfig`` from a dict of its fields; unknown keys are
    ignored."""
    known = {f.name for f in dataclasses.fields(ViTConfig)}
    kwargs = {k: v for k, v in d.items() if k in known and v is not None}
    for key in ("dtype", "param_dtype"):
        if isinstance(kwargs.get(key), str):
            kwargs[key] = DTYPES[kwargs[key]]
    return ViTConfig(**kwargs)


def param_shapes(cfg: ViTConfig) -> dict:
    """The parameter tree's leaf shapes, in the flax pytree's nesting."""
    L, h, m, p = cfg.num_layers, cfg.hidden_size, cfg.mlp_dim, cfg.patch_size
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    def ln(*lead):
        return {"scale": (*lead, h), "bias": (*lead, h)}

    attn = {"qkv_kernel": (L, h, 3, nh, hd), "out_kernel": (L, nh, hd, h),
            "out_bias": (L, h)}
    if cfg.qkv_bias:
        attn["qkv_bias"] = (L, 3, nh, hd)
    shapes = {
        "patch_kernel": (p, p, cfg.in_channels, h), "patch_bias": (h,),
        "cls_token": (1, 1, h), "pos_embed": (1, cfg.num_patches + 1, h),
        "blocks": {"ln1": ln(L), "attn": attn, "ln2": ln(L),
                   "mlp": {"wi_kernel": (L, h, m), "wi_bias": (L, m),
                           "wo_kernel": (L, m, h), "wo_bias": (L, h)}},
        "ln_f": ln(),
    }
    head_in = h
    if cfg.representation_size:
        head_in = cfg.representation_size
        shapes["pre_logits_kernel"] = (h, head_in)
        shapes["pre_logits_bias"] = (head_in,)
    shapes["head_kernel"] = (head_in, cfg.num_classes)
    shapes["head_bias"] = (cfg.num_classes,)
    return shapes


#: leaves drawn from the truncated normal (std 0.02, cut at ±2 std)
_TRUNC_NORMAL = ("qkv_kernel", "out_kernel", "wi_kernel", "wo_kernel",
                 "pos_embed", "pre_logits_kernel")


def init_params(cfg: ViTConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> dict:
    """Seeded init in the JAX layout on ``device`` (the JAX init's
    distributions, not its bits)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(node: Any, path: tuple) -> Any:
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        out = torch.empty(node, dtype=cfg.param_dtype, device=device)
        if name in _TRUNC_NORMAL:
            return torch.nn.init.trunc_normal_(out, 0.0, 0.02, -0.04, 0.04,
                                               generator=gen)
        if name == "patch_kernel":
            # flax xavier_uniform: fans over the receptive field
            receptive = math.prod(node[:-2])
            fan_avg = (node[-2] * receptive + node[-1] * receptive) / 2
            limit = math.sqrt(3.0 / fan_avg)
            return out.uniform_(-limit, limit, generator=gen)
        return out.fill_(1.0 if name == "scale" else 0.0)

    return build(param_shapes(cfg), ())


def _ln(p: dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """``ViTLayerNorm``: f32 statistics, the result in the compute
    dtype."""
    return f32_layer_norm(x, p["scale"], p["bias"], cfg.layer_norm_epsilon,
                          cfg.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return x @ w.to(dtype) + b.to(dtype)


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              rng: Optional[DropoutRng]) -> torch.Tensor:
    """``DropPath``: each sample's branch kept with probability
    ``1 - rate`` (one draw per sample) and scaled by ``1 / keep``."""
    if rate == 0.0 or deterministic:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = SH.global_rand(shape, rng.row_block(x.shape[0]), rng.gen,
                          x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def attention(p: dict, x: torch.Tensor, cfg: ViTConfig, *,
              deterministic: bool,
              rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ViTAttention``: bidirectional attention, an f32 softmax."""
    b, s, h = x.shape
    nh, hd, dtype = cfg.num_attention_heads, cfg.head_dim, cfg.dtype
    x = x.to(dtype)
    qkv = (x @ p["qkv_kernel"].to(dtype).reshape(h, 3 * nh * hd)).reshape(
        b, s, 3, nh, hd)
    if cfg.qkv_bias:
        qkv = qkv + p["qkv_bias"].to(dtype)
    q, k, v = qkv.unbind(2)
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(
        device=x.device, dtype=dtype)
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / root
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if cfg.attn_drop_rate > 0.0 and not deterministic:
        probs = _dropout(probs, cfg.attn_drop_rate, rng)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, nh * hd)
    return _dense(out, p["out_kernel"].reshape(nh * hd, h), p["out_bias"],
                  dtype)


def mlp(p: dict, x: torch.Tensor, cfg: ViTConfig, *, deterministic: bool,
        rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ViTMlp``: dense GELU (tanh) FFN, dropout after the GELU."""
    y = F.gelu(_dense(x.to(cfg.dtype), p["wi_kernel"], p["wi_bias"],
                      cfg.dtype), approximate="tanh")
    if cfg.drop_rate > 0.0 and not deterministic:
        y = _dropout(y, cfg.drop_rate, rng)
    return _dense(y, p["wo_kernel"], p["wo_bias"], cfg.dtype)


def block(p: dict, x: torch.Tensor, cfg: ViTConfig, *, deterministic: bool,
          rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ViTBlock``: pre-norm attention and MLP, DropPath on each
    residual branch."""
    y = attention(p["attn"], _ln(p["ln1"], x, cfg), cfg,
                  deterministic=deterministic, rng=rng)
    x = x + drop_path(y, cfg.drop_path_rate, deterministic, rng)
    y = mlp(p["mlp"], _ln(p["ln2"], x, cfg), cfg,
            deterministic=deterministic, rng=rng)
    return x + drop_path(y, cfg.drop_path_rate, deterministic, rng)


def patch_embed(params: dict, cfg: ViTConfig,
                images: torch.Tensor) -> torch.Tensor:
    """NHWC images → ``[b, patches, h]``: the stride-``p`` VALID
    convolution with the HWIO kernel, as one matmul over row-major
    patches."""
    b, H, W, c = images.shape
    p, dtype = cfg.patch_size, cfg.dtype
    gh, gw = H // p, W // p
    x = images[:, :gh * p, :gw * p].to(dtype).reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
    return _dense(x, params["patch_kernel"].reshape(p * p * c, -1),
                  params["patch_bias"], dtype)


def vit(params: dict, cfg: ViTConfig, images: torch.Tensor, *,
        deterministic: bool = True,
        rng: Optional[DropoutRng] = None) -> torch.Tensor:
    """``ViT``: logits ``[b, num_classes]`` in the compute dtype."""
    dtype = cfg.dtype
    x = patch_embed(params, cfg, images)
    cls = params["cls_token"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    if cfg.drop_rate > 0.0 and not deterministic:
        x = _dropout(x, cfg.drop_rate, rng)
    for bp in _unstack(params["blocks"], cfg.num_layers):
        fn = functools.partial(block, bp, cfg=cfg,
                               deterministic=deterministic, rng=rng)
        x = recompute(fn, rng, x) if cfg.use_recompute else fn(x)
    feat = _ln(params["ln_f"], x, cfg)[:, 0]
    if cfg.representation_size:
        feat = torch.tanh(_dense(feat, params["pre_logits_kernel"],
                                 params["pre_logits_bias"], dtype))
    return _dense(feat, params["head_kernel"], params["head_bias"], dtype)
