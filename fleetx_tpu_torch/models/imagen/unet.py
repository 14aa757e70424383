"""Efficient U-Net of one Imagen cascade stage.

Port of ``fleetx_tpu/models/imagen/unet.py``: ``UNetConfig`` (:23-40),
``timestep_embedding`` (:43-49), ``PerceiverResampler`` (:52-91),
``ResnetBlock`` (:94-129), ``SpatialAttention`` (:132-155) and
``EfficientUNet`` (:158-260), as plain functions over a params dict.

The tree keeps flax's names (``down_0_0/norm1/scale``,
``down_attn_2/attn/query/kernel``, ``resampler/latents``, ``null_text``,
...), so the name-based decay mask is JAX's. Two kinds of leaf are kept
in the layout PyTorch computes with, converted once from JAX's
(``convert.imagen_params_from_jax``): a convolution kernel is ``[out, kh,
kw, in]`` (JAX's HWIO ``[kh, kw, in, out]``; permuted to OIHW it is
channels-last in memory, the layout cuDNN runs fastest), and an
attention projection (flax ``DenseGeneral``) is a 2-D ``[c, heads·hd]``
matrix (JAX's ``[c, heads, hd]``; the output's ``[heads, hd, c]`` becomes
``[heads·hd, c]``; the q/k/v biases ``[heads, hd]`` become ``[heads·hd]``).
``jax_param_shapes`` gives JAX's shapes, ``param_shapes`` the port's.

Images are NHWC, as in JAX; each convolution takes the NCHW view of an
NHWC tensor (channels-last memory) and gives it back as NHWC without a
copy. The JAX padding ``"SAME"`` is computed per call (for the stride-2
4x4 downsample at an even size it is 1 on each side). Flax's norms are
kept exactly: ``LayerNorm`` and ``GroupNorm`` (``epsilon`` 1e-6) take
their statistics in f32 with the fast variance ``mean(x²) - mean(x)²``
clamped at 0, groups over consecutive channels, and return f32. Flax's
``MultiHeadDotProductAttention`` scales the query by ``1/sqrt(hd)``, masks
with ``finfo.min`` and takes the softmax in the compute dtype. ``gelu``
is the tanh form and ``swish`` is SiLU. Nearest resizing is
``jax.image.resize``'s half-pixel rule (``nearest-exact``). Nothing here
is a hand-written kernel: JAX's U-Net is plain flax, and no Pallas kernel
is on its path.

The parameters for text conditioning (``resampler``, ``null_text``,
``text_pool``, the cross-attention ``text_proj``) are always in the
tree: the recipes always carry text features, and the JAX module's init
sees them. ``lowres_time_mlp`` is there when the stage conditions on a
noise-augmented low-res image (``lowres_cond`` with ``lowres_noise_aug``
above 0), as JAX's init makes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from fleetx_tpu_torch.models.gpt.model import DTYPES, DropoutRng, _dropout

#: flax's LayerNorm / GroupNorm default epsilon
NORM_EPS = 1e-6


@dataclasses.dataclass
class UNetConfig:
    """One cascade stage's architecture."""

    dim: int = 64
    dim_mults: tuple = (1, 2, 4)
    num_res_blocks: int = 2
    text_embed_dim: int = 64     # precomputed T5 feature width
    cond_dim: int = 64           # internal conditioning width
    num_attn_heads: int = 4
    layer_attns: tuple = (False, False, True)
    layer_cross_attns: tuple = (False, False, True)
    num_latents: int = 16        # PerceiverResampler latent count
    channels: int = 3
    lowres_cond: bool = False    # SR stages condition on the upsampled image
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def dims(self) -> list:
        return [self.dim * m for m in self.dim_mults]


def config_from_dict(d: dict) -> UNetConfig:
    """A ``UNetConfig`` from a dict; unknown keys are ignored."""
    known = {f.name for f in dataclasses.fields(UNetConfig)}
    kw = {k: v for k, v in d.items() if k in known and v is not None}
    for key in ("dim_mults", "layer_attns", "layer_cross_attns"):
        if key in kw:
            kw[key] = tuple(kw[key])
    for key in ("dtype", "param_dtype"):
        if isinstance(kw.get(key), str):
            kw[key] = DTYPES[kw[key]]
    return UNetConfig(**kw)


# ------------------------------------------------------------ the tree
def _dense(i: int, o: int) -> dict:
    return {"kernel": (i, o), "bias": (o,)}


def _norm(c: int) -> dict:
    return {"scale": (c,), "bias": (c,)}


def _conv(k: int, i: int, o: int) -> dict:
    return {"kernel": (k, k, i, o), "bias": (o,)}


def _mhdpa(c: int, heads: int) -> dict:
    hd = c // heads
    proj = {"kernel": (c, heads, hd), "bias": (heads, hd)}
    return {"query": dict(proj), "key": dict(proj), "value": dict(proj),
            "out": {"kernel": (heads, hd, c), "bias": (c,)}}


def _resblock(i: int, o: int, emb: int) -> dict:
    out = {"norm1": _norm(i), "conv1": _conv(3, i, o),
           "film": _dense(emb, 2 * o), "norm2": _norm(o),
           "conv2": _conv(3, o, o)}
    if i != o:
        out["skip"] = _conv(1, i, o)
    return out


def _spatial(c: int, cfg: UNetConfig, cross: bool) -> dict:
    out = {"ln": _norm(c)}
    if cross:
        out["text_proj"] = _dense(cfg.cond_dim, c)
    out["attn"] = _mhdpa(c, cfg.num_attn_heads)
    return out


def jax_param_shapes(cfg: UNetConfig, lowres_time: bool = False) -> dict:
    """The flax tree's leaf shapes (JAX's layouts)."""
    cd, emb = cfg.cond_dim, cfg.cond_dim * 4
    tree: dict = {"time_mlp1": _dense(cd, emb), "time_mlp2": _dense(emb, emb)}
    if cfg.lowres_cond and lowres_time:
        tree["lowres_time_mlp"] = _dense(cd, emb)
    res: dict = {"proj_in": _dense(cfg.text_embed_dim, cd),
                 "latents": (cfg.num_latents, cd)}
    for i in range(2):
        res.update({f"ln_q{i}": _norm(cd), f"ln_kv{i}": _norm(cd),
                    f"xattn{i}": _mhdpa(cd, cfg.num_attn_heads),
                    f"ln_ff{i}": _norm(cd), f"ff_in{i}": _dense(cd, 4 * cd),
                    f"ff_out{i}": _dense(4 * cd, cd)})
    tree["resampler"] = res
    tree["null_text"] = (cfg.num_latents, cd)
    tree["text_pool"] = _dense(cd, emb)
    in_ch = cfg.channels * (2 if cfg.lowres_cond else 1)
    tree["conv_in"] = _conv(3, in_ch, cfg.dim)
    dims, ch = cfg.dims, cfg.dim
    for i, d in enumerate(dims):
        for j in range(cfg.num_res_blocks):
            tree[f"down_{i}_{j}"] = _resblock(ch, d, emb)
            ch = d
        if cfg.layer_attns[i]:
            tree[f"down_attn_{i}"] = _spatial(ch, cfg, False)
        if cfg.layer_cross_attns[i]:
            tree[f"down_xattn_{i}"] = _spatial(ch, cfg, True)
        if i < len(dims) - 1:
            tree[f"down_{i}_ds"] = _conv(4, ch, dims[i + 1])
            ch = dims[i + 1]
    tree["mid1"] = _resblock(ch, dims[-1], emb)
    tree["mid_xattn"] = _spatial(dims[-1], cfg, True)
    tree["mid2"] = _resblock(dims[-1], dims[-1], emb)
    ch = dims[-1]
    for i, d in reversed(list(enumerate(dims))):
        if i < len(dims) - 1:
            tree[f"up_{i}_us"] = _conv(3, ch, d)
            ch = d
        for j in range(cfg.num_res_blocks):
            tree[f"up_{i}_{j}"] = _resblock(ch + d, d, emb)
            ch = d
        if cfg.layer_attns[i]:
            tree[f"up_attn_{i}"] = _spatial(ch, cfg, False)
        if cfg.layer_cross_attns[i]:
            tree[f"up_xattn_{i}"] = _spatial(ch, cfg, True)
    tree["norm_out"] = _norm(ch)
    tree["conv_out"] = _conv(3, ch, cfg.channels)
    return tree


def port_leaf(path: tuple, shape: tuple) -> tuple:
    """JAX's leaf shape at ``path`` → the port's (module docstring)."""
    if len(shape) == 4:                      # HWIO → OHWI
        return (shape[3], shape[0], shape[1], shape[2])
    if len(shape) == 3:                      # DenseGeneral kernels
        if path[-2] == "out":
            return (shape[0] * shape[1], shape[2])
        return (shape[0], shape[1] * shape[2])
    if len(shape) == 2 and path[-1] == "bias":   # q/k/v biases
        return (shape[0] * shape[1],)
    return tuple(shape)


def to_port_leaf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """JAX's leaf value at ``path`` in the port's layout."""
    if arr.ndim == 4:
        return np.ascontiguousarray(np.transpose(arr, (3, 0, 1, 2)))
    return np.ascontiguousarray(arr.reshape(port_leaf(path, arr.shape)))


def map_leaves(tree: Any, fn, path: tuple = ()) -> Any:
    """``tree``'s nesting with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shapes(cfg: UNetConfig, lowres_time: bool = False) -> dict:
    """The port's tree: JAX's names, the port's layouts."""
    return map_leaves(jax_param_shapes(cfg, lowres_time), port_leaf)


def init_params(cfg: UNetConfig, lowres_time: bool = False, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> dict:
    """Seeded init with flax's distributions (not its bits): kernels
    lecun-normal (a normal truncated at ±2 std, std ``sqrt(1/fan_in) /
    0.8796``; fan-in over the receptive field and input channels, over
    the input features of a projection), ``latents`` and ``null_text``
    N(0, 0.02), norm scales 1, biases 0."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def leaf(path: tuple, shape: tuple) -> torch.Tensor:
        name = path[-1]
        out = torch.empty(shape, dtype=cfg.param_dtype, device=device)
        if name == "kernel":
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            return out.mul_(std)
        if name in ("latents", "null_text"):
            return out.normal_(0.0, 0.02, generator=gen)
        return out.fill_(1.0 if name == "scale" else 0.0)

    return map_leaves(param_shapes(cfg, lowres_time), leaf)


# ------------------------------------------------------------ the layers
def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal time features ``[cos, sin]`` in f32, the frequencies
    formed as JAX forms them (``-log(max_period)`` in f32, times the index,
    over ``half``)."""
    half = dim // 2
    log_p = torch.log(torch.tensor(max_period, dtype=torch.float32,
                                   device=t.device))
    freqs = torch.exp(-log_p * torch.arange(half, dtype=torch.float32,
                                            device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dense(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: operands cast to ``dtype``, bias added
    after the product."""
    return x.to(dtype) @ p["kernel"].to(dtype) + p["bias"].to(dtype)


def layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` over the last axis."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x32 - mean) * (torch.rsqrt(var + NORM_EPS) * p["scale"]) \
        + p["bias"]


def group_norm(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """flax ``GroupNorm(dtype=float32)`` of an NHWC tensor: statistics per
    sample over the spatial axes and ``groups`` runs of consecutive
    channels."""
    b, c = x.shape[0], x.shape[-1]
    x32 = x.float()
    g = x32.reshape(b, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3))
    var = torch.clamp((g * g).mean(dim=(1, 3)) - mean * mean, min=0.0)
    size = c // groups
    mean = mean.repeat_interleave(size, dim=1)[:, None, None, :]
    var = var.repeat_interleave(size, dim=1)[:, None, None, :]
    return (x32 - mean) * (torch.rsqrt(var + NORM_EPS) * p["scale"]) \
        + p["bias"]


def _same_pad(n: int, k: int, s: int) -> tuple:
    """JAX's ``"SAME"`` padding ``(lo, hi)`` of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(p: dict, x: torch.Tensor, dtype: torch.dtype,
         stride: int = 1) -> torch.Tensor:
    """flax ``Conv(padding="SAME")`` on NHWC ``x`` with an OHWI kernel."""
    k = p["kernel"].shape[1]
    (t, b), (l, r) = (_same_pad(x.shape[1], k, stride),
                      _same_pad(x.shape[2], k, stride))
    xc = x.to(dtype).permute(0, 3, 1, 2)
    w = p["kernel"].to(dtype).permute(0, 3, 1, 2)
    if t == b and l == r:
        y = F.conv2d(xc, w, p["bias"].to(dtype), stride, (t, l))
    else:
        y = F.conv2d(F.pad(xc, (l, r, t, b)), w, p["bias"].to(dtype),
                     stride)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of NHWC ``x`` (half-pixel
    centres)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def attention(p: dict, q_in: torch.Tensor, kv_in: torch.Tensor, heads: int,
              dtype: torch.dtype,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention`` (q ``[b, lq, c]``, kv
    ``[b, lk, c]``; ``mask`` broadcast to ``[b, heads, lq, lk]``)."""
    q = dense(p["query"], q_in, dtype)
    k = dense(p["key"], kv_in, dtype)
    v = dense(p["value"], kv_in, dtype)
    b, lq, c = q.shape
    hd = c // heads
    q = q.reshape(b, lq, heads, hd)
    k = k.reshape(b, -1, heads, hd)
    v = v.reshape(b, -1, heads, hd)
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    q = q / root.to(device=q.device, dtype=dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        w = torch.where(mask, w, torch.full_like(w, torch.finfo(w.dtype).min))
    w = torch.softmax(w, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, lq, c)
    return dense(p["out"], out, dtype)


def perceiver_resampler(p: dict, text_embeds: torch.Tensor,
                        text_mask: Optional[torch.Tensor],
                        cfg: UNetConfig) -> torch.Tensor:
    """``PerceiverResampler``: ``num_latents`` latents cross-attend twice
    to the text tokens and themselves."""
    dtype = cfg.dtype
    b = text_embeds.shape[0]
    x = dense(p["proj_in"], text_embeds, dtype)
    lat = p["latents"].to(dtype).expand(b, cfg.num_latents, cfg.cond_dim)
    mask = None
    if text_mask is not None:
        mask = torch.cat([text_mask.bool(), torch.ones(
            (b, cfg.num_latents), dtype=torch.bool, device=x.device)],
            dim=1)[:, None, None, :]
    for i in range(2):
        q = layer_norm(p[f"ln_q{i}"], lat)
        kv = layer_norm(p[f"ln_kv{i}"], torch.cat([x, lat], dim=1))
        lat = lat + attention(p[f"xattn{i}"], q.to(dtype), kv.to(dtype),
                              cfg.num_attn_heads, dtype, mask)
        h = layer_norm(p[f"ln_ff{i}"], lat)
        h = F.gelu(dense(p[f"ff_in{i}"], h, dtype), approximate="tanh")
        lat = lat + dense(p[f"ff_out{i}"], h, dtype)
    return lat


def resnet_block(p: dict, x: torch.Tensor, emb: torch.Tensor,
                 cfg: UNetConfig, rng: Optional[DropoutRng]) -> torch.Tensor:
    """``ResnetBlock``: GroupNorm → swish → conv, FiLM scale-shift from
    the conditioning embedding, GroupNorm → swish → (dropout) → conv, and
    the residual (a 1x1 conv where the width changes)."""
    dtype = cfg.dtype
    in_ch, out_ch = x.shape[-1], p["conv1"]["kernel"].shape[0]
    h = F.silu(group_norm(p["norm1"], x, min(8, in_ch))).to(dtype)
    h = conv(p["conv1"], h, dtype)
    ss = dense(p["film"], F.silu(emb.float()), dtype)[:, None, None, :]
    scale, shift = ss.chunk(2, dim=-1)
    h = group_norm(p["norm2"], h, min(8, out_ch))
    h = h * (1.0 + scale.float()) + shift.float()
    h = F.silu(h).to(dtype)
    if cfg.dropout > 0.0 and rng is not None:
        h = _dropout(h, cfg.dropout, rng)
    h = conv(p["conv2"], h, dtype)
    if "skip" in p:
        x = conv(p["skip"], x, dtype)
    return x + h


def spatial_attention(p: dict, x: torch.Tensor, cfg: UNetConfig,
                      text_latents: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``SpatialAttention``: self-attention over the pixels, with the
    projected text latents appended to the keys for a cross block."""
    dtype = cfg.dtype
    b, hh, ww, c = x.shape
    q = layer_norm(p["ln"], x.reshape(b, hh * ww, c)).to(dtype)
    kv = q
    if "text_proj" in p and text_latents is not None:
        kv = torch.cat([q, dense(p["text_proj"], text_latents, dtype)],
                       dim=1)
    out = attention(p["attn"], q, kv, cfg.num_attn_heads, dtype)
    return x + out.reshape(b, hh, ww, c)


def efficient_unet(p: dict, cfg: UNetConfig, x: torch.Tensor,
                   t: torch.Tensor,
                   text_embeds: Optional[torch.Tensor] = None,
                   text_mask: Optional[torch.Tensor] = None,
                   cond_drop_mask: Optional[torch.Tensor] = None,
                   lowres_img: Optional[torch.Tensor] = None,
                   lowres_t: Optional[torch.Tensor] = None,
                   rng: Optional[DropoutRng] = None) -> torch.Tensor:
    """``EfficientUNet``: the noise (or v) prediction ``[b, h, w, c]`` f32
    for noisy NHWC images ``x`` at timesteps ``t`` (dropout on when
    ``rng`` is given)."""
    dtype = cfg.dtype
    x = x.to(dtype)
    if cfg.lowres_cond:
        if lowres_img is None:
            raise ValueError("an SR stage (lowres_cond) needs lowres_img")
        if lowres_img.shape[1] != x.shape[1]:
            lowres_img = resize_nearest(lowres_img, x.shape[1], x.shape[2])
        x = torch.cat([x, lowres_img.to(dtype)], dim=-1)
    emb = dense(p["time_mlp1"], timestep_embedding(t, cfg.cond_dim),
                torch.float32)
    emb = dense(p["time_mlp2"], F.silu(emb), torch.float32)
    if cfg.lowres_cond and lowres_t is not None:
        emb = emb + dense(p["lowres_time_mlp"], timestep_embedding(
            lowres_t, cfg.cond_dim), torch.float32)
    latents = None
    if text_embeds is not None:
        latents = perceiver_resampler(p["resampler"], text_embeds, text_mask,
                                      cfg)
        if cond_drop_mask is not None:  # CFG null-conditioning dropout
            keep = cond_drop_mask[:, None, None].to(latents.dtype)
            latents = latents * keep \
                + p["null_text"].to(latents.dtype)[None] * (1 - keep)
        pooled = latents.float().mean(dim=1)
        emb = emb + dense(p["text_pool"], pooled, torch.float32)

    h = conv(p["conv_in"], x, dtype)
    dims = cfg.dims
    skips = []
    for i in range(len(dims)):
        for j in range(cfg.num_res_blocks):
            h = resnet_block(p[f"down_{i}_{j}"], h, emb, cfg, rng)
            skips.append(h)
        if cfg.layer_attns[i]:
            h = spatial_attention(p[f"down_attn_{i}"], h, cfg)
        if cfg.layer_cross_attns[i] and latents is not None:
            h = spatial_attention(p[f"down_xattn_{i}"], h, cfg, latents)
        if i < len(dims) - 1:
            h = conv(p[f"down_{i}_ds"], h, dtype, stride=2)
    h = resnet_block(p["mid1"], h, emb, cfg, rng)
    if latents is not None:
        h = spatial_attention(p["mid_xattn"], h, cfg, latents)
    h = resnet_block(p["mid2"], h, emb, cfg, rng)
    for i in reversed(range(len(dims))):
        if i < len(dims) - 1:
            h = resize_nearest(h, h.shape[1] * 2, h.shape[2] * 2)
            h = conv(p[f"up_{i}_us"], h, dtype)
        for j in range(cfg.num_res_blocks):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet_block(p[f"up_{i}_{j}"], h, emb, cfg, rng)
        if cfg.layer_attns[i]:
            h = spatial_attention(p[f"up_attn_{i}"], h, cfg)
        if cfg.layer_cross_attns[i] and latents is not None:
            h = spatial_attention(p[f"up_xattn_{i}"], h, cfg, latents)
    h = F.silu(group_norm(p["norm_out"], h, min(8, h.shape[-1]))).to(dtype)
    return conv(p["conv_out"], h, dtype).float()
