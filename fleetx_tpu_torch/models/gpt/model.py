"""GPT config and parameters in the JAX package's layout.

Port of ``fleetx_tpu/models/gpt/model.py:45-136`` (the ``GPTConfig``
fields serving reads) and ``:871-895`` (``PRESETS``,
``config_from_dict``). Parameters are a nested dict of tensors shaped
exactly like the flax pytree (``nn.scan`` stacks layer leaves on a
leading ``[num_layers]`` dim; ``qkv_kernel [h, 3, nh, hd]``,
``out_kernel [nh, hd, h]``, ``model.py:315-327``), so converted JAX
weights and the port's own seeded init are interchangeable and tests
compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

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
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    moe_num_experts: int = 0   # 0 = dense FFN; MoE is not ported yet
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

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
    """Build a GPTConfig from a YAML ``Model:`` section; keys that only
    the training path reads (dropout, recompute, flash/fused-norm knobs)
    are ignored here, as the JAX loader ignores unknown keys."""
    known = {f.name for f in dataclasses.fields(GPTConfig)}
    kwargs = {k: v for k, v in d.items() if k in known and v is not None}
    for key in ("dtype", "param_dtype"):
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
            "mlp": {"wi_kernel": (L, h, f), "wi_bias": (L, f),
                    "wo_kernel": (L, f, h), "wo_bias": (L, h)},
        },
        "ln_f": ln(),
    }}


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
            out = torch.empty(node, dtype=cfg.param_dtype, device=device)
            return out.normal_(0.0, cfg.initializer_range, generator=gen)
        fill = 1.0 if path[-1] == "scale" else 0.0
        return torch.full(node, fill, dtype=cfg.param_dtype, device=device)

    return build(param_shapes(cfg), ())
