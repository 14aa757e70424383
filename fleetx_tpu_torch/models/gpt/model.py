"""GPT config, parameters and the training forward in the JAX layout.

Port of ``fleetx_tpu/models/gpt/model.py``: ``GPTConfig`` (:45-136) with
the training knobs, ``PRESETS`` / ``config_from_dict`` (:871-895), and the
forward of ``GPTEmbeddings``, ``MultiHeadAttention._core_attn``,
``GPTMlp``, ``LayerNorm``, ``TransformerDecoderLayer``, ``GPTModel`` and
``GPTForPretraining`` (:299-767) with the remat granularities ``full``,
``full_attn``, ``core_attn`` and ``dots`` (:423, :547-555, :639-651;
``recompute`` here; the ``dots`` policy and its save points, :138-268,
are ``dots_policy`` and ``save_residual``), QAT's fake-quant
sites (:331-337, :370-374, :475-489), ``chunked_cross_entropy_per_token``
(:770-843),
``cross_entropy_per_token``, ``masked_mean`` and ``cross_entropy_loss``
(:846-866), the MoE stack (:120-123, :568-581; the FFN in ``moe.py``),
and the dense decode cache generation runs on:
``DecodeCache`` / ``init_cache`` (:275-297), the cache path of
``MultiHeadAttention`` (:346-363) with ``_decode_attention`` (:443-460),
and position ids from the cache index or the left-pad mask (:621-640).

On a mesh (``cfg.shard``, a ``parallel/sharding.ShardCtx`` the engine
sets; None for one rank) the training forward is Megatron's: each rank
holds its ``nh/mp`` heads, the column-parallel ``qkv_kernel`` /
``wi_kernel`` and the row-parallel ``out_kernel`` / ``wo_kernel`` blocks,
and its ``vocab/mp`` rows of ``word_embeddings``; ``attention`` and
``mlp`` enter their region through ``copy_to_tensor`` and leave it
through ``reduce_from_tensor``, whose psum runs in the compute dtype
before the bias is added once. The lookup is vocab-parallel (each rank's
rows, a psum), and so is the LM head with its cross entropy
(``cross_entropy_per_token``: a pmax of the row maxima, a psum of the
exponent sums and of the label logit from the shard that owns it; the
chunked head's chunks lie inside the rank's vocab slice). Under
``sequence_parallel`` the residual stream, the LayerNorms and the
residual dropouts hold the rank's block of the sequence, and the regions
are entered by ``gather_seq`` and left by ``scatter_seq``; the
LayerNorms' and the replicated biases' grads are then partial sums over
``tensor``, which the engine's grad sync psums. At ZeRO stage 3 each
layer's leaves are all-gathered over ``fsdp`` inside the layer
(``ShardCtx.gathered``), so a recomputed layer gathers again in the
backward. Every dropout mask is a function of global coordinates: the
hidden masks are drawn at the global shape from the shared generator and
sliced to the rank's rows and sequence block (``sharding.global_rand``),
and the flash kernels' hash is keyed on the global batch-head index.
Under QAT each abs-max covers the whole tensor: a ``pmax`` over the data
axes, and over ``tensor`` where the operand is split there.

Parameters are a nested dict of tensors shaped exactly like the flax
pytree (``nn.scan`` stacks layer leaves on a leading ``[num_layers]`` dim;
``qkv_kernel [h, 3, nh, hd]``, ``out_kernel [nh, hd, h]``,
``model.py:315-327``), so converted JAX weights and the port's own seeded
init are interchangeable and tests compare like with like. The forward is
plain functions over that dict: ``nn.scan`` becomes a Python loop over
the layer index of the stacked leaves (``unbind`` once per call, so the
backward stacks the per-layer grads in one pass).

The reference's cast points are kept: weights ``.to(dtype)`` at use (one
cast per use, so a tied leaf's two grads sum in f32 at the leaf), a
compute-dtype residual stream, f32 LayerNorm, an f32 softmax and f32
logsumexp. ``use_ring_attention`` routes attention through
``ops/ring_attention.py``; otherwise ``use_flash_attention`` and
``fused_residual_norm`` pick the hand-written kernels (``ops/flash_attention.py``, ``ops/fused_norm.py``)
where their gates admit the shape, and the plain ``finfo.min``-masked
softmax / unfused LayerNorm otherwise, as the JAX module does.

With a cache, attention never reaches the flash kernels (the prompt too
goes through ``_decode_attention``, as in the JAX module), while every
LayerNorm still takes the fused kernel where its gate admits the shape
(``[b, s, hidden]`` at any ``s``): 2 × layers + 1 launches a model call.
The port's cache is written in place by the call that fills it (at the
positions ``index + arange(s)``, an ``index_copy_``), and a call returns
the same cache object with ``index`` advanced. ``index`` is a host int in
eager generation or a 0-d int64 tensor: an exported decode step
(``torch.export``) takes the write position as an input, so one program
serves every step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fleetx_tpu_torch.models.gpt.moe import moe_mlp
from fleetx_tpu_torch.ops import flash_attention as FA
from fleetx_tpu_torch.ops import fused_norm as FN
from fleetx_tpu_torch.ops import ring_attention as RA
from fleetx_tpu_torch.ops import save_points as SP
from fleetx_tpu_torch.ops.quantization import fake_quant
from fleetx_tpu_torch.parallel import mesh as PM
from fleetx_tpu_torch.parallel import sharding as SH

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass
class GPTConfig:
    """Architecture + execution config (the YAML ``Model:`` section)."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    ffn_hidden_size: Optional[int] = None  # defaults to 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_recompute: bool = False
    # full | full_attn | core_attn | dots (save the matmul outputs and the
    # kernels' outputs, recompute the rest: ``dots_policy``)
    recompute_granularity: str = "full"
    # dots only: the dtype the four named residuals are saved in (None
    # keeps the compute dtype); the forward is rounded through it too
    remat_save_dtype: Optional[torch.dtype] = None
    # dots only: in JAX the saved residuals' buffer layout (exact math);
    # here it picks the names policy (True) or the bare dots policy
    remat_consumed_layout: bool = True
    # dtype of the gradient-accumulation carry; None ("native") keeps the
    # grads' own dtype
    grad_accum_dtype: Optional[torch.dtype] = torch.float32
    use_flash_attention: bool = True
    flash_fused_bwd: bool = True
    fused_residual_norm: bool = True
    sequence_parallel: bool = False
    use_ring_attention: bool = False
    # stream the einsum ring path's K/V in chunks of this many tokens
    ring_kv_chunk: Optional[int] = None
    # the chunked LM head's vocab chunk (memory cap); None = full logits
    vocab_chunk: Optional[int] = None
    # QAT: fake-quant every matmul's operands in the forward (the cached
    # forward too, as in JAX), weights per output channel at qat_bits,
    # activations per tensor at qat_act_bits; the quantized serving decode
    # (``serving/decode.py``) reads the same widths
    use_qat: bool = False
    qat_bits: int = 8
    qat_act_bits: int = 8
    moe_num_experts: int = 0   # 0 = dense FFN; >0 = MoE (``moe.py``)
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # the mesh of a sharded run (``parallel/sharding.ShardCtx``), set by
    # the engine; None on one rank. Not a YAML key.
    shard: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    # name: (layers, hidden, heads, ffn)
    "GPT-345M": (24, 1024, 16, 4096),
    "GPT-1.3B": (24, 2048, 16, 8192),
    "GPT-6.7B": (32, 4096, 32, 16384),
    "GPT-13B": (40, 5120, 40, 20480),
    "GPT-175B": (96, 12288, 96, 49152),
}


def config_from_dict(d: dict) -> GPTConfig:
    """Build a GPTConfig from a YAML ``Model:`` section; keys it does not
    know are ignored, as the JAX loader ignores them."""
    known = {f.name for f in dataclasses.fields(GPTConfig)} - {"shard"}
    kwargs = {k: v for k, v in d.items() if k in known and v is not None}
    if str(kwargs.get("grad_accum_dtype")).lower() == "native":
        kwargs["grad_accum_dtype"] = None
    for key in ("dtype", "param_dtype", "grad_accum_dtype",
                "remat_save_dtype"):
        if isinstance(kwargs.get(key), str):
            kwargs[key] = DTYPES[kwargs[key]]
    return GPTConfig(**kwargs)


def param_shapes(cfg: GPTConfig) -> dict:
    """The parameter tree's leaf shapes, in the flax pytree's nesting."""
    L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    def ln(*lead):
        return {"scale": (*lead, h), "bias": (*lead, h)}

    return {"gpt": {
        "embeddings": {
            "word_embeddings": (cfg.vocab_size, h),
            "position_embeddings": (cfg.max_position_embeddings, h),
        },
        "layers": {
            "ln1": ln(L),
            "attn": {"qkv_kernel": (L, h, 3, nh, hd),
                     "qkv_bias": (L, 3, nh, hd),
                     "out_kernel": (L, nh, hd, h),
                     "out_bias": (L, h)},
            "ln2": ln(L),
            "mlp": _mlp_shapes(cfg),
        },
        "ln_f": ln(),
    }}


def _mlp_shapes(cfg: GPTConfig) -> dict:
    """The dense FFN's leaves, or the MoE stack's (``MoEMlp``'s params,
    experts on axis 1 after the layers)."""
    L, h, f, E = cfg.num_layers, cfg.hidden_size, cfg.ffn_dim, \
        cfg.moe_num_experts
    if E > 0:
        return {"router_kernel": (L, h, E), "wi_kernel": (L, E, h, f),
                "wi_bias": (L, E, f), "wo_kernel": (L, E, f, h),
                "wo_bias": (L, E, h)}
    return {"wi_kernel": (L, h, f), "wi_bias": (L, f),
            "wo_kernel": (L, f, h), "wo_bias": (L, h)}


def _is_normal(path: tuple) -> bool:
    """Kernels and embeddings draw N(0, initializer_range); biases are 0,
    LayerNorm scales 1 (``model.py:_dense_init`` and the param calls)."""
    return path[-1].endswith("_kernel") or path[-1].endswith("_embeddings")


def init_params(cfg: GPTConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu") -> dict:
    """Seeded init in the JAX layout, on ``device``.

    Same distribution as the flax init, not the same bits: JAX's threefry
    and torch's generators never agree, so tests that compare the two
    sides convert one set of weights (``convert.params_from_jax``).
    """
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(node: Any, path: tuple) -> Any:
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if _is_normal(path):
            # the MoE router is f32 whatever the param dtype (``moe.py:46``)
            dtype = torch.float32 if path[-1] == "router_kernel" \
                else cfg.param_dtype
            out = torch.empty(node, dtype=dtype, device=device)
            return out.normal_(0.0, cfg.initializer_range, generator=gen)
        fill = 1.0 if path[-1] == "scale" else 0.0
        return torch.full(node, fill, dtype=cfg.param_dtype, device=device)

    return build(param_shapes(cfg), ())


# ------------------------------------------------------------ forward
@dataclasses.dataclass
class DropoutRng:
    """One training step's dropout randomness: a hash seed per layer for
    the flash kernels' in-kernel attention dropout, and a device generator
    for every other dropout mask. ``rows`` is ``(block, blocks)`` of a
    rank that holds one of ``blocks`` equal blocks of the batch rows
    (None on one rank): its masks are its rows of the global batch's."""

    layer_seeds: list
    gen: torch.Generator
    rows: Optional[tuple] = None

    def row_block(self, n: int) -> dict:
        """``{0: (offset, total)}`` of a rank's ``n`` rows (empty on one
        rank)."""
        if self.rows is None or self.rows[1] == 1:
            return {}
        return {0: (self.rows[0] * n, self.rows[1] * n)}


def dropout_rng(seed: int, step: int, num_layers: int,
                device: Union[str, torch.device],
                shard: Any = None) -> DropoutRng:
    """Step ``step``'s randomness from ONE generator seeded by ``seed``
    with the step folded in (as ``jax.random.fold_in(rng, step)`` in the
    JAX ``GPTModule.training_loss``); ``shard`` (a ``ShardCtx``) places
    the rank's rows in the global batch."""
    host = torch.Generator()
    host.manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                     | (int(step) & 0xFFFFFFFF))
    draws = torch.randint(0, 2 ** 31 - 1, (num_layers + 1,),
                          generator=host).tolist()
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(draws[-1])
    rows = None if shard is None else (shard.data_index(), shard.data_world)
    return DropoutRng(draws[:-1], gen, rows)


def _dropout(x: torch.Tensor, rate: float, rng: DropoutRng,
             blocks: Optional[dict] = None) -> torch.Tensor:
    """``flax.linen.Dropout``: keep with probability ``1 - rate``, scale
    kept values by ``1 / (1 - rate)`` in ``x``'s dtype. Dim 0 is the
    batch: on a mesh ``rng.rows`` places the rank's rows, and ``blocks``
    (dim → ``(offset, total)``, ``_blocks``) its other blocks, in the
    global tensor whose mask is drawn."""
    blocks = {**rng.row_block(x.shape[0]), **(blocks or {})}
    u = SH.global_rand(tuple(x.shape), blocks, rng.gen, x.device)
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


def _blocks(cfg: GPTConfig, x: torch.Tensor, seq_dim: Optional[int] = None,
            head_dim: Optional[int] = None) -> dict:
    """Where ``x`` sits in its global tensor on a mesh besides its rows
    (``DropoutRng.rows``): ``seq_dim`` its sequence block under sequence
    parallelism, ``head_dim`` its heads."""
    sh = cfg.shard
    if sh is None:
        return {}
    out = {}
    if seq_dim is not None and sh.sp:
        out[seq_dim] = sh.block("tensor", x.shape[seq_dim])
    if head_dim is not None and sh.tensor > 1:
        out[head_dim] = sh.block("tensor", x.shape[head_dim])
    return out


def _mesh(cfg: GPTConfig):
    return None if cfg.shard is None else cfg.shard.mesh


def _enter(x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """Into a tensor-parallel region: the whole sequence under sequence
    parallelism (``gather_seq``), else ``copy_to_tensor``."""
    sh = cfg.shard
    if sh is None:
        return x
    return SH.gather_seq(x, sh.mesh) if sh.sp else \
        SH.copy_to_tensor(x, sh.mesh)


def _leave(y: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """Out of a row-parallel product: the summed rank's sequence block
    under sequence parallelism (``scatter_seq``), else the psum
    (``reduce_from_tensor``)."""
    sh = cfg.shard
    if sh is None:
        return y
    return SH.scatter_seq(y, sh.mesh) if sh.sp else \
        SH.reduce_from_tensor(y, sh.mesh)


def _fq(x: torch.Tensor, bits: int, cfg: GPTConfig, axis=None,
        over_tensor: bool = False, over_data: bool = False
        ) -> torch.Tensor:
    """``fake_quant`` whose abs-max covers the whole tensor on a mesh:
    a pmax over the data axes (an activation's rows) and over ``tensor``
    (an operand split there)."""
    sh = cfg.shard
    axes = (SH.DATA_AXES if over_data else ()) + \
        (("tensor",) if over_tensor else ())
    if sh is None or all(sh.mesh.shape[a] == 1 for a in axes):
        return fake_quant(x, bits, axis=axis)
    if axis is None:
        amax = x.detach().abs().amax()
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        amax = x.detach().abs().amax(dim=dims, keepdim=True)
    for a in axes:
        amax = PM.pmax(amax, a, sh.mesh)
    return fake_quant(x, bits, axis=axis, amax=amax)


def recompute(fn, rng: Optional[DropoutRng], *args,
              keep: Optional[frozenset] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, as ``jax.checkpoint`` / ``nn.remat`` do. With ``keep`` (a
    set of ``ops/save_points.py`` kinds, ``dots_policy``) the span keeps
    the outputs of its save points of those kinds from the forward, and
    the recomputation takes them back instead of making them again.

    Every hidden-dropout mask draws from ``rng.gen``, an explicit
    generator that checkpointing does not restore, so the recomputation
    would draw other masks than the forward and the grads would be
    silently wrong. The generator's state is taken at the start of the
    span, set back to it when the recomputation starts, and returned to
    where the first forward left it when the recomputation ends (also when
    it stops early). The flash kernels' attention dropout is a hash of
    ``(layer seed, head, row, col)`` and needs nothing. No draw uses the
    default generators, so checkpoint's own RNG stash is off.
    """
    points = SP.SavePoints(keep or ())
    start = rng.gen.get_state() if rng is not None else None
    ran = []

    def replay(*a):
        if not ran:  # the first forward
            ran.append(True)
            with SP.recording(points):
                return fn(*a)
        resume = rng.gen.get_state() if rng is not None else None
        if rng is not None:
            rng.gen.set_state(start)
        try:
            with SP.replaying(points):
                return fn(*a)
        finally:
            if rng is not None:
                rng.gen.set_state(resume)

    return checkpoint(replay, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ------------------------------------------------------- the dots policy
#: the four saved post-bias matmul outputs of a layer under the names
#: policy (``RESIDUAL_NAMES``, ``fleetx_tpu/models/gpt/model.py:158``)
RESIDUAL_NAMES = ("res_qkv", "res_attn_out", "res_mlp_wi", "res_mlp_wo")


def _transform_gate_active(cfg: GPTConfig) -> bool:
    """The save-point transforms act only under ``use_recompute`` with
    ``dots``, and never for MoE (``model.py:187-196``)."""
    return (cfg.use_recompute and cfg.recompute_granularity == "dots"
            and cfg.moe_num_experts == 0)


def _residual_casts_active(cfg: GPTConfig) -> bool:
    """The named residuals round-trip through ``remat_save_dtype``."""
    return cfg.remat_save_dtype is not None and _transform_gate_active(cfg)


def _residual_layouts_active(cfg: GPTConfig) -> bool:
    """``remat_consumed_layout`` under the gate (JAX: the saved buffers'
    layout; here: the names policy, see ``dots_policy``)."""
    return bool(cfg.remat_consumed_layout) and _transform_gate_active(cfg)


def _residual_transforms_active(cfg: GPTConfig) -> bool:
    """Either transform on → the names policy applies."""
    return _residual_casts_active(cfg) or _residual_layouts_active(cfg)


def _dense_plain(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` plus ``b``, whose shape splits ``n``."""
    return (x @ w).reshape(*x.shape[:-1], *b.shape) + b


def _mm_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """``(dx, dw)`` of ``x @ w`` the way autograd takes them through the
    folded matmul: ``mm``'s two products for a row-major ``w``."""
    g2 = g.reshape(-1, w.shape[1])
    dx = g2.mm(w.t()).reshape(x.shape)
    dw = x.reshape(-1, w.shape[0]).t().mm(g2)
    return dx, dw


class _KeptMatmul(torch.autograd.Function):
    """``x @ w`` as a save point of kind ``"dot"``: the dots policy keeps
    the matmul output, and the bias add after it reruns."""

    @staticmethod
    def forward(ctx, x, w):
        """``x @ w``, kept by a span that keeps ``"dot"``."""
        ctx.save_for_backward(x, w)
        return SP.kept("dot", lambda: x @ w)

    @staticmethod
    def backward(ctx, g):
        """``(dx, dw)`` as autograd takes them (``_mm_grads``)."""
        return _mm_grads(*ctx.saved_tensors, g)


class _KeptResidual(torch.autograd.Function):
    """``(x @ w + b).to(save)`` as a save point of kind ``"residual"``:
    the names policy keeps the post-bias value in its save dtype (JAX's
    ``checkpoint_name`` on it). The backward is the one autograd takes
    through ``_dense_plain`` and the cast: the cotangent cast back to the
    compute dtype, ``b``'s sum over the leading dims, the matmul's two
    products."""

    @staticmethod
    def forward(ctx, x, w, b, save):
        """The post-bias value in ``save``, kept by a span that keeps
        ``"residual"``."""
        ctx.save_for_backward(x, w)
        ctx.bias_dims = b.dim()
        return SP.kept("residual", lambda: _dense_plain(x, w, b).to(save))

    @staticmethod
    def backward(ctx, g):
        """``(dx, dw, db)`` through the cast, the bias add and the
        matmul."""
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        db = g.sum(dim=tuple(range(g.dim() - ctx.bias_dims)))
        dx, dw = _mm_grads(x, w, g)
        return dx, dw, db, None


def save_residual(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  name: str, cfg: GPTConfig,
                  cached: bool = False) -> torch.Tensor:
    """JAX's ``_save_residual`` (``model.py:215-250``) on the post-bias
    matmul output ``x @ w + b`` named ``name`` (one of
    ``RESIDUAL_NAMES``), taking the operands instead of the value, since
    the save point is the call that makes it.

    Under ``dots`` (with ``use_recompute``, not for a cached forward,
    which has no backward; MoE's too, whose transforms are off, so its
    projections are ``"dot"`` save points, as JAX's dots policy saves
    them): with a save-point transform active, the value
    is a ``"residual"`` save point; with the casts active it is made in
    ``remat_save_dtype`` and cast back, so the forward is quantized too.
    Without a transform the matmul output is a ``"dot"`` save point and
    the bias add reruns. Otherwise, the plain ``x @ w + b``. The values
    are the plain ones bit for bit, the cast's rounding apart."""
    if name not in RESIDUAL_NAMES:
        raise ValueError(f"{name!r} is not one of {RESIDUAL_NAMES}")
    if cached or not (cfg.use_recompute
                      and cfg.recompute_granularity == "dots"):
        return _dense_plain(x, w, b)
    if _residual_transforms_active(cfg):
        save = cfg.remat_save_dtype if _residual_casts_active(cfg) \
            else x.dtype
        return _KeptResidual.apply(x, w, b, save).to(x.dtype)
    y = _KeptMatmul.apply(x, w)
    return y.reshape(*x.shape[:-1], *b.shape) + b


def dots_policy(cfg: GPTConfig) -> frozenset:
    """The save-point kinds (``ops/save_points.py``) a ``dots`` span
    keeps, what JAX's ``_dots_policy`` (``model.py:253-268``) saves:

    - with either save-point transform active, the four named residuals
      (``"residual"``); otherwise the four projections' matmul outputs
      (``"dot"``: JAX's ``dots_with_no_batch_dims_saveable``; the
      attention's batched products are not among them, in JAX either);
    - with ``use_flash_attention`` on, the outputs of the flash forward
      and of the fused-norm forward (``"kernel"``; JAX's
      ``_flash_residuals_saveable`` keeps every Pallas output), so the
      backward reruns neither kernel. With it off, JAX returns the bare
      dots policy, and the norm kernel reruns here too.

    ``remat_consumed_layout`` changes only the layout JAX writes the saved
    buffers in, and its math is exact; PyTorch keeps a tensor as it is,
    so here the field only picks the names policy over the dots policy
    (the losses and grads are the same either way).
    """
    kinds = {"residual" if _residual_transforms_active(cfg) else "dot"}
    if cfg.use_flash_attention:
        kinds.add("kernel")
    return frozenset(kinds)


def layer_norm(p: dict, x: torch.Tensor, cfg: GPTConfig,
               residual: Optional[torch.Tensor] = None):
    """``LayerNorm``: f32 pre-norm; with ``residual`` it folds the block
    residual add and returns ``(out, s)`` with ``s = residual + x``."""
    if cfg.fused_residual_norm and FN.fused_norm_supported(x, residual):
        out, s = FN.fused_residual_norm(
            x, p["scale"], p["bias"], residual=residual,
            eps=cfg.layer_norm_epsilon, out_dtype=cfg.dtype)
        return out if residual is None else (out, s)
    s = x if residual is None else residual + x
    out = f32_layer_norm(s, p["scale"], p["bias"], cfg.layer_norm_epsilon,
                         cfg.dtype)
    return out if residual is None else (out, s)


def f32_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The plain LayerNorm of the JAX modules (GPT's unfused one, ERNIE's
    and ViT's): statistics and affine in f32, the result cast to
    ``dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


@dataclasses.dataclass
class DecodeCache:
    """KV cache for autoregressive decode. ``mask`` marks the cached key
    positions that hold a real token: left-pad prompt positions stay
    masked for good."""

    key: torch.Tensor    # [layers, batch, max_len, heads, head_dim]
    value: torch.Tensor  # [layers, batch, max_len, heads, head_dim]
    # number of positions already written: a host int, or a 0-d int64
    # tensor on the cache's device
    index: Union[int, torch.Tensor]
    mask: torch.Tensor   # [batch, max_len] bool, True where a key is real

    def positions(self, s: int) -> torch.Tensor:
        """The ``s`` slots the next call writes: ``index + arange(s)``."""
        return self.index + torch.arange(s, device=self.mask.device)

    def select(self, rows: torch.Tensor) -> "DecodeCache":
        """A cache of the batch rows ``rows`` (repeats and the beam
        reorder)."""
        return DecodeCache(self.key[:, rows], self.value[:, rows],
                           self.index, self.mask[rows])


def init_cache(cfg: GPTConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Union[str, torch.device] = "cpu") -> DecodeCache:
    """An empty decode cache for ``batch`` rows of ``max_len``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_attention_heads,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return DecodeCache(
        key=torch.zeros(shape, dtype=dtype, device=device),
        value=torch.zeros(shape, dtype=dtype, device=device), index=0,
        mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device))


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache_index: Union[int, torch.Tensor],
                      key_mask: torch.Tensor) -> torch.Tensor:
    """Attention of ``q`` (the tokens written at ``cache_index`` on) over
    the whole cache: a key counts when its slot is at or before the
    query's and ``key_mask`` marks it real; ``finfo.min``-masked f32
    softmax."""
    root = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32)
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / \
        root.to(device=q.device, dtype=q.dtype)
    q_pos = cache_index + torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (k_pos <= q_pos)[None] & key_mask[:, None, :]
    scores = torch.where(mask[:, None], scores, torch.full_like(
        scores, torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _plain_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: GPTConfig, rate: float,
                rng: Optional[DropoutRng]) -> torch.Tensor:
    """The ``finfo.min``-masked f32 softmax attention (``plain``)."""
    root = torch.tensor(math.sqrt(cfg.head_dim), dtype=torch.float32)
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / \
        root.to(device=q.device, dtype=q.dtype)
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, torch.full_like(
        scores, torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if rate > 0.0:
        probs = _dropout(probs, rate, rng, _blocks(cfg, probs, head_dim=1))
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def core_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: GPTConfig, *, deterministic: bool,
              rng: Optional[DropoutRng], layer: int) -> torch.Tensor:
    """``MultiHeadAttention._core_attn``: causal attention over
    ``[b, s, heads, head_dim]``: the ring path under
    ``use_ring_attention`` (no attention dropout there, as in JAX), else
    the flash kernels where ``supported`` admits the shape, else the
    ``finfo.min``-masked f32 softmax; recomputed in the backward under
    the ``core_attn`` granularity."""
    rate = 0.0 if deterministic else cfg.attention_probs_dropout_prob
    if cfg.use_ring_attention:
        if rate > 0.0:
            raise ValueError("ring attention does not support attention "
                             "dropout (Model.attention_probs_dropout_prob "
                             "must be 0.0)")
        fn = functools.partial(RA.ring_attention, causal=True,
                               kv_chunk=cfg.ring_kv_chunk)
    elif cfg.use_flash_attention and FA.supported(q, k):
        seed = rng.layer_seeds[layer] if rate > 0.0 else 0
        fn = functools.partial(FA.flash_attention, causal=True,
                               fused_bwd=cfg.flash_fused_bwd,
                               dropout_rate=rate, dropout_seed=seed,
                               heads=_head_map(cfg, q))
    else:
        fn = functools.partial(_plain_attn, cfg=cfg, rate=rate, rng=rng)
    if cfg.use_recompute and cfg.recompute_granularity == "core_attn":
        return recompute(fn, rng, q, k, v)
    return fn(q, k, v)


def _head_map(cfg: GPTConfig, q: torch.Tensor) -> tuple:
    """The flash kernels' head map of a rank's ``q [b, s, heads, hd]``:
    ``(heads here, heads in all, first global row, first global head)``."""
    if cfg.shard is None:
        return FA.NO_SHARD
    b, n = q.shape[0], q.shape[2]
    row = cfg.shard.block(SH.DATA_AXES, b)[0]
    head = cfg.shard.block("tensor", n)[0]
    return (n, cfg.num_attention_heads, row, head)


def attention(p: dict, x: torch.Tensor, cfg: GPTConfig, *,
              deterministic: bool, rng: Optional[DropoutRng],
              layer: int, cache: Optional[DecodeCache] = None
              ) -> torch.Tensor:
    """``MultiHeadAttention``: fused qkv, core, out. With a cache, this
    call's k/v go into layer ``layer``'s slots from ``cache.index`` on and
    attention runs over the whole cache (``_decode_attention``).

    Under QAT the matmul operands are fake-quantized in the compute dtype
    (``model.py:331-337, 370-374``): the input per tensor at
    ``qat_act_bits``, the kernels per output channel at ``qat_bits``. The
    port reduces the kernels after their reshape to 2-D, over axis 0: the
    same scales as JAX's ``axis=0`` of ``qkv_kernel [h, 3, nh, hd]`` and
    ``axis=(0, 1)`` of ``out_kernel [nh, hd, h]``.

    On a mesh ``x`` is the rank's rows (its sequence block under sequence
    parallelism) and the kernels its heads' blocks: the region is entered
    and left as ``_enter`` / ``_leave`` say, and ``out_bias`` is added
    once, after the psum."""
    cached = cache is not None
    x = _enter(x.to(cfg.dtype), cfg)
    b, s, h = x.shape
    nh, hd = p["qkv_kernel"].shape[-2], cfg.head_dim
    w = p["qkv_kernel"].to(cfg.dtype).reshape(h, 3 * nh * hd)
    if cfg.use_qat:
        x = _fq(x, cfg.qat_act_bits, cfg, over_data=True)
        w = fake_quant(w, cfg.qat_bits, axis=0)
    qkv = save_residual(x, w, p["qkv_bias"].to(cfg.dtype), "res_qkv", cfg,
                        cached)
    q, k, v = qkv.unbind(2)
    if cache is not None:
        slots = cache.positions(s)
        cache.key[layer].index_copy_(1, slots, k.to(cache.key.dtype))
        cache.value[layer].index_copy_(1, slots, v.to(cache.value.dtype))
        out = _decode_attention(q, cache.key[layer], cache.value[layer],
                                cache.index, cache.mask)
    else:
        out = core_attn(q, k, v, cfg, deterministic=deterministic, rng=rng,
                        layer=layer)
    out = out.reshape(b, s, nh * hd)
    w_out = p["out_kernel"].to(cfg.dtype).reshape(nh * hd, h)
    if cfg.use_qat:
        out = _fq(out, cfg.qat_act_bits, cfg, over_tensor=True,
                  over_data=True)
        w_out = _fq(w_out, cfg.qat_bits, cfg, axis=0, over_tensor=True)
    return _row_parallel(out, w_out, p["out_bias"], "res_attn_out", cfg,
                         cached)


def _row_parallel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  name: str, cfg: GPTConfig, cached: bool) -> torch.Tensor:
    """``save_residual(x, w, b)`` of a row-parallel product: on a mesh the
    partial sums leave the region (``_leave``) and the bias is added once,
    after them."""
    if cfg.shard is None:
        return save_residual(x, w, b.to(cfg.dtype), name, cfg, cached)
    y = save_residual(x, w, torch.zeros_like(b, dtype=cfg.dtype), name, cfg,
                      cached)
    return _leave(y, cfg) + b.to(cfg.dtype)


def mlp(p: dict, x: torch.Tensor, cfg: GPTConfig,
        cached: bool = False) -> torch.Tensor:
    """``GPTMlp``: dense 4h FFN with tanh-approximate GELU; under QAT the
    input, both kernels (per output channel) and the GELU output are
    fake-quantized (``model.py:475-489``). On a mesh ``wi_kernel`` is
    column-parallel and ``wo_kernel`` row-parallel, ``wo_bias`` added once
    after the psum."""
    x = _enter(x.to(cfg.dtype), cfg)
    wi, wo = p["wi_kernel"].to(cfg.dtype), p["wo_kernel"].to(cfg.dtype)
    if cfg.use_qat:
        x = _fq(x, cfg.qat_act_bits, cfg, over_data=True)
        wi = fake_quant(wi, cfg.qat_bits, axis=0)
        wo = _fq(wo, cfg.qat_bits, cfg, axis=0, over_tensor=True)
    y = save_residual(x, wi, p["wi_bias"].to(cfg.dtype), "res_mlp_wi", cfg,
                      cached)
    y = F.gelu(y, approximate="tanh")
    if cfg.use_qat:
        y = _fq(y, cfg.qat_act_bits, cfg, over_tensor=True, over_data=True)
    return _row_parallel(y, wo, p["wo_bias"], "res_mlp_wo", cfg, cached)


def decoder_layer(p: dict, x: torch.Tensor, cfg: GPTConfig, *,
                  deterministic: bool, rng: Optional[DropoutRng],
                  layer: int, cache: Optional[DecodeCache] = None):
    """``TransformerDecoderLayer``: pre-norm attention and MLP blocks, the
    post-attention residual add folded into ``ln2``; the attention call
    recomputed in the backward under the ``full_attn`` granularity (never
    with a cache: decode has no backward). Returns ``(x, aux)``: ``aux``
    is the MoE FFN's weighted load-balance loss (``moe.py``; the MoE FFN
    takes no QAT fake-quant, as in JAX), None for the dense FFN."""
    drop = cfg.hidden_dropout_prob > 0.0 and not deterministic
    if cfg.shard is not None:
        p = _gather_layer(p, cfg)
    residual = x
    y = layer_norm(p["ln1"], x, cfg)

    def attn(y):
        return attention(p["attn"], y, cfg, deterministic=deterministic,
                         rng=rng, layer=layer, cache=cache)

    if cfg.use_recompute and cfg.recompute_granularity == "full_attn" \
            and cache is None:
        y = recompute(attn, rng, y)
    else:
        y = attn(y)
    if drop:
        y = _dropout(y, cfg.hidden_dropout_prob, rng,
                     _blocks(cfg, y, seq_dim=1))
    y, x = layer_norm(p["ln2"], y, cfg, residual=residual)
    residual = x
    if cfg.moe_num_experts > 0:
        y, aux = moe_mlp(p["mlp"], y, cfg)
    else:
        y, aux = mlp(p["mlp"], y, cfg, cached=cache is not None), None
    if drop:
        y = _dropout(y, cfg.hidden_dropout_prob, rng,
                     _blocks(cfg, y, seq_dim=1))
    return residual + y, aux


def _gather_layer(p: dict, cfg: GPTConfig, prefix: str = "gpt/layers"
                  ) -> dict:
    """One layer's leaves whole over ``fsdp`` where ZeRO stage 3 keeps
    them sharded (inside the layer: a recomputed layer gathers again)."""
    return {k: _gather_layer(v, cfg, f"{prefix}/{k}") if isinstance(v, dict)
            else cfg.shard.gathered(f"{prefix}/{k}", v, stacked=True)
            for k, v in p.items()}


def _unstack(node: Any, n: int) -> list:
    """Stacked ``[layers, ...]`` leaves → one dict per layer (views)."""
    if isinstance(node, dict):
        per_key = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: per_key[k][i] for k in node} for i in range(n)]
    return list(node.unbind(0))


def gpt_model(params: dict, cfg: GPTConfig, tokens: torch.Tensor,
              position_ids: Optional[torch.Tensor] = None, *,
              deterministic: bool = True,
              rng: Optional[DropoutRng] = None,
              cache: Optional[DecodeCache] = None,
              attention_mask: Optional[torch.Tensor] = None,
              return_aux: bool = False):
    """``GPTModel``: embeddings, decoder stack, ``ln_f``; each decoder
    layer recomputed in the backward under the ``full`` granularity (only
    the layer inputs stay live) and under ``dots`` (``dots_policy``: the
    matmul and kernel outputs stay live too).

    With ``return_aux``, ``(x, aux)``: ``aux`` is the MoE layers'
    load-balance losses summed over the layers (JAX's sum of the scanned
    ``losses`` collection), None for a dense stack.

    With a cache, the call writes its tokens at ``cache.index`` on, marks
    those key slots real where ``attention_mask`` says so (all of them
    without one), and advances the index. Position ids default to the
    count of real tokens before each one for a left-padded prefill
    (``attention_mask`` with a cache), else to ``cache.index`` (0 without
    a cache) plus the offset in the call.
    """
    p = params["gpt"]
    s = tokens.shape[1]
    if position_ids is None:
        if attention_mask is not None and cache is not None:
            position_ids = torch.clamp(
                torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1,
                min=0)
        else:
            start = cache.index if cache is not None else 0
            position_ids = (start + torch.arange(
                s, device=tokens.device)).expand(tokens.shape)
    if cache is not None:
        cache.mask.index_copy_(
            1, cache.positions(s),
            torch.ones_like(tokens, dtype=torch.bool)
            if attention_mask is None else attention_mask.bool())
    wte, wpe = _embedding_tables(params, cfg)
    if cfg.shard is None:
        x = F.embedding(tokens, wte) + F.embedding(position_ids, wpe)
    else:
        x = _leave(_vocab_lookup(tokens, wte, cfg), cfg)
        if cfg.shard.sp:
            lo, _ = cfg.shard.block("tensor", x.shape[1])
            position_ids = position_ids[:, lo:lo + x.shape[1]]
        x = x + F.embedding(position_ids, wpe)
    if cfg.hidden_dropout_prob > 0.0 and not deterministic:
        x = _dropout(x, cfg.hidden_dropout_prob, rng,
                     _blocks(cfg, x, seq_dim=1))
    remat = cfg.use_recompute and cache is None and \
        cfg.recompute_granularity in ("full", "dots")
    keep = dots_policy(cfg) if cfg.recompute_granularity == "dots" \
        else None
    auxes = []
    for i, lp in enumerate(_unstack(p["layers"], cfg.num_layers)):
        layer = functools.partial(decoder_layer, lp, cfg=cfg,
                                  deterministic=deterministic, rng=rng,
                                  layer=i, cache=cache)
        x, aux = recompute(layer, rng, x, keep=keep) if remat else layer(x)
        if aux is not None:
            auxes.append(aux)
    if cache is not None:
        cache.index = cache.index + s
    out = layer_norm(p["ln_f"], x, cfg)
    if cfg.shard is not None and cfg.shard.sp:
        out = SH.gather_seq(out, cfg.shard.mesh)
    if not return_aux:
        return out
    return out, (torch.stack(auxes).sum() if auxes else None)


def gpt_for_pretraining(params: dict, cfg: GPTConfig, tokens: torch.Tensor,
                        position_ids: Optional[torch.Tensor] = None, *,
                        deterministic: bool = True,
                        rng: Optional[DropoutRng] = None,
                        labels: Optional[torch.Tensor] = None,
                        loss_mask: Optional[torch.Tensor] = None,
                        cache: Optional[DecodeCache] = None,
                        attention_mask: Optional[torch.Tensor] = None,
                        return_aux: bool = False):
    """``GPTForPretraining``: logits ``[b, s, vocab]`` in the compute dtype
    from the tied embedding head; with ``cfg.vocab_chunk`` set and
    ``labels`` given (and no cache), the masked LM loss through the
    chunked head instead (the ``[b, s, vocab]`` logits are never built).
    With a cache (generation), ``(logits, cache)``. Without a cache and
    with ``return_aux``, ``(out, aux)``, ``aux`` as ``gpt_model``'s."""
    x, aux = gpt_model(params, cfg, tokens, position_ids,
                       deterministic=deterministic, rng=rng, cache=cache,
                       attention_mask=attention_mask, return_aux=True)
    wte = _embedding_tables(params, cfg)[0]
    if cache is not None:
        return torch.einsum("bsh,vh->bsv", x, wte), cache
    if cfg.shard is not None and not cfg.shard.sp:
        x = SH.copy_to_tensor(x, cfg.shard.mesh)
    if cfg.vocab_chunk and labels is not None:
        losses = chunked_cross_entropy_per_token(x, wte, labels,
                                                 int(cfg.vocab_chunk), cfg)
        mask = torch.ones_like(losses) if loss_mask is None else loss_mask
        out = masked_mean(losses, mask, cfg)
    else:
        out = torch.einsum("bsh,vh->bsv", x, wte)
    return (out, aux) if return_aux else out


def _embedding_tables(params: dict, cfg: GPTConfig) -> tuple:
    """``(word, position)`` tables in the compute dtype, whole over
    ``fsdp`` on a mesh that keeps them sharded there (stage 3); the word
    table is the rank's vocab rows under tensor parallelism."""
    emb = params["gpt"]["embeddings"]
    wte, wpe = emb["word_embeddings"], emb["position_embeddings"]
    if cfg.shard is not None:
        wte = cfg.shard.gathered("gpt/embeddings/word_embeddings", wte)
        wpe = cfg.shard.gathered("gpt/embeddings/position_embeddings", wpe)
    return wte.to(cfg.dtype), wpe.to(cfg.dtype)


def vocab_offset(cfg: GPTConfig, local_vocab: int) -> int:
    """The first vocab id of this rank's rows of the word table."""
    if cfg.shard is None or cfg.shard.tensor == 1:
        return 0
    return cfg.shard.block("tensor", local_vocab)[0]


def _vocab_lookup(tokens: torch.Tensor, wte: torch.Tensor,
                  cfg: GPTConfig) -> torch.Tensor:
    """The rank's share of the embedding lookup: the rows of its vocab
    slice, zeros for the ids another rank owns (their sum over ``tensor``
    is the lookup)."""
    lo = vocab_offset(cfg, wte.shape[0])
    if cfg.shard.tensor == 1:
        return F.embedding(tokens, wte)
    local = tokens - lo
    own = (local >= 0) & (local < wte.shape[0])
    e = F.embedding(torch.where(own, local, torch.zeros_like(local)), wte)
    return torch.where(own[..., None], e, torch.zeros_like(e))


def gather_logits(logits: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The whole vocab of a rank's logits (its slice on ``tensor``)."""
    if cfg.shard is None:
        return logits
    return PM.all_gather(logits, "tensor", cfg.shard.mesh, dim=-1)


def chunk_geometry(vocab: int, vocab_chunk: int):
    """``(chunk, n_chunks, pad)``: the cap snapped to the smallest chunk
    with the same count, re-aligned up to 128 and never above the cap
    (``model.py:799-806``)."""
    cap = min(int(vocab_chunk), vocab)
    n_chunks = -(-vocab // cap)
    base = -(-vocab // n_chunks)
    chunk = min(-(-base // 128) * 128, cap)
    n_chunks = -(-vocab // chunk)
    return chunk, n_chunks, n_chunks * chunk - vocab


#: above this many chunks the stats fold into running (m, l, label) as
#: they come (the JAX ``lax.scan`` path) instead of being merged at once
_MAX_UNROLLED_CHUNKS = 32


def chunked_cross_entropy_per_token(x: torch.Tensor, wte: torch.Tensor,
                                    labels: torch.Tensor,
                                    vocab_chunk: int,
                                    cfg: Optional[GPTConfig] = None
                                    ) -> torch.Tensor:
    """Token-level LM loss without the ``[b, s, V]`` logits
    (``chunked_cross_entropy_per_token``, ``model.py:770-843``).

    Each vocab chunk's (row max, sum of exp at that max, label logit) is
    computed independently from ``x @ w_chunkᵀ`` in f32 and the stats are
    merged into the exact logsumexp. Each chunk runs under ``checkpoint``,
    so its ``[b, s, chunk]`` f32 logits are freed after its stats and
    rebuilt in the backward: at most one such block is live. Padded ids of
    the last chunk score -1e30.

    On a mesh with tensor parallelism ``wte`` is the rank's vocab slice:
    the chunks lie inside it, and the slices' stats merge over ``tensor``
    as ``cross_entropy_per_token``'s do.
    """
    vocab = wte.shape[0]
    chunk, n_chunks, pad = chunk_geometry(vocab, vocab_chunk)
    wte_p = F.pad(wte, (0, 0, 0, pad)) if pad else wte
    labels = labels.long()
    if cfg is not None:
        # the rank's vocab slice: ids of other slices land in no chunk
        labels = labels - vocab_offset(cfg, vocab)
        labels = torch.where((labels >= 0) & (labels < vocab), labels,
                             torch.full_like(labels, -1))

    def one_chunk(x, w, ci):
        logits = torch.einsum("bsh,vh->bsv", x, w).float()
        if pad:
            ids = ci * chunk + torch.arange(chunk, device=x.device)
            logits = torch.where(ids < vocab, logits,
                                 torch.full_like(logits, -1e30))
        m = logits.amax(dim=-1)
        l = torch.exp(logits - m[..., None]).sum(dim=-1)
        local = torch.clamp(labels - ci * chunk, 0, chunk - 1)
        ll = logits.gather(-1, local[..., None])[..., 0]
        in_ch = (labels >= ci * chunk) & (labels < (ci + 1) * chunk)
        return m, l, torch.where(in_ch, ll, torch.zeros_like(ll))

    def stats(ci):
        return checkpoint(one_chunk, x, wte_p[ci * chunk:(ci + 1) * chunk],
                          ci, use_reentrant=False, preserve_rng_state=False)

    if n_chunks <= _MAX_UNROLLED_CHUNKS:
        parts = [stats(ci) for ci in range(n_chunks)]
        m = functools.reduce(torch.maximum, [p[0] for p in parts])
        l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
        lab = sum(p[2] for p in parts)  # the label lands in one chunk
        return _merge_vocab_slices(m, l, lab, cfg)
    b, s = labels.shape
    m = torch.full((b, s), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    lab = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for ci in range(n_chunks):
        cm, cl, clab = stats(ci)
        m_new = torch.maximum(m, cm)
        l = l * torch.exp(m - m_new) + cl * torch.exp(cm - m_new)
        m, lab = m_new, lab + clab
    return _merge_vocab_slices(m, l, lab, cfg)


def _merge_vocab_slices(m: torch.Tensor, l: torch.Tensor, lab: torch.Tensor,
                        cfg: Optional[GPTConfig]) -> torch.Tensor:
    """``logsumexp - label logit`` from each rank's (row max, sum of exp
    at that max, label logit) over its vocab slice: a pmax of the maxima
    (a constant to autograd, as the logsumexp does not depend on it), a
    psum of the rescaled sums and of the label logits (one owner)."""
    mesh = _mesh(cfg) if cfg is not None else None
    if mesh is None or mesh.shape["tensor"] == 1:
        return m + torch.log(l) - lab
    g = PM.pmax(m.detach(), "tensor", mesh)
    l = SH.reduce_from_tensor(l * torch.exp(m - g), mesh)
    return g + torch.log(l) - SH.reduce_from_tensor(lab, mesh)


def cross_entropy_per_token(logits: torch.Tensor, labels: torch.Tensor,
                            cfg: Optional[GPTConfig] = None
                            ) -> torch.Tensor:
    """Unreduced token-level LM loss, f32 logsumexp. On a mesh with
    tensor parallelism ``logits`` is the rank's vocab slice: the label's
    logit comes from the slice that owns it and the slices' stats merge
    over ``tensor`` (``_merge_vocab_slices``)."""
    logits = logits.float()
    mesh = _mesh(cfg) if cfg is not None else None
    if mesh is None or mesh.shape["tensor"] == 1:
        logz = torch.logsumexp(logits, dim=-1)
        label_logits = logits.gather(-1, labels[..., None].long())[..., 0]
        return logz - label_logits
    v = logits.shape[-1]
    local = labels.long() - vocab_offset(cfg, v)
    own = (local >= 0) & (local < v)
    picked = logits.gather(-1, torch.where(own, local, torch.zeros_like(
        local))[..., None])[..., 0]
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    return _merge_vocab_slices(
        m, l, torch.where(own, picked, torch.zeros_like(picked)), cfg)


def masked_mean(losses: torch.Tensor, loss_mask: torch.Tensor,
                cfg: Optional[GPTConfig] = None) -> torch.Tensor:
    """Mask-weighted mean of per-token losses; on a mesh the global one:
    the psum of the ranks' masked sums over the psum of their masks (the
    sum a ``global_sum``, so each rank's grads stay its share)."""
    loss_mask = loss_mask.float().reshape(losses.shape)
    num, den = (losses * loss_mask).sum(), loss_mask.sum()
    mesh = _mesh(cfg) if cfg is not None else None
    if mesh is not None:
        num = SH.global_sum(num, mesh)
        den = PM.psum_axes(den, SH.DATA_AXES, mesh)
    return num / torch.clamp(den, min=1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       loss_mask: torch.Tensor,
                       cfg: Optional[GPTConfig] = None) -> torch.Tensor:
    """Masked LM loss (``cross_entropy_loss``); global on a mesh."""
    return masked_mean(cross_entropy_per_token(logits, labels, cfg),
                       loss_mask, cfg)
