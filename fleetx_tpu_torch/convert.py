"""JAX parameter pytree → the port's parameter dict.

``params_from_jax(tree, cfg, device)`` takes the tree as
``jax.device_get(flax.core.meta.unbox(params))`` gives it (nested dicts of
numpy arrays) and returns the same nesting of torch tensors on
``device``: the stacked ``[layers, ...]`` leaves, ``qkv_kernel`` /
``qkv_bias`` / ``out_kernel`` / ``out_bias``, ``mlp.wi_*`` / ``wo_*``,
``ln1`` / ``ln2`` / ``ln_f``, and the tied ``word_embeddings`` plus
``position_embeddings``, and the LoRA ``<kernel>_lora_a`` /
``<kernel>_lora_b`` pairs of a fine-tune tree next to the four target
kernels (``finetune/lora.py``; their rank read from the tree). A missing
or extra leaf, or a shape that differs from
``models/gpt/model.py:param_shapes`` (and ``lora.adapter_shapes``),
raises.
``check_tree(tree, cfg)`` runs the same checks on anything with a
``.shape`` (``jax.eval_shape`` output) without converting a byte, so a
full-size tree (GPT-1.3B) can be checked without its weights.

The encoder families the same way, in JAX's scanned layout:
``ernie_params_from_jax`` / ``check_ernie_tree`` against
``models/ernie/model.py:param_shapes`` (layer leaves stacked under
``ernie/layers``) and ``vit_params_from_jax`` / ``check_vit_tree``
against ``models/vision/vit.py:param_shapes`` (block leaves under
``blocks``). The MoE GPT's tree is ``params_from_jax``'s too: its
``mlp`` holds ``router_kernel`` ``[L, h, E]`` (f32) and the experts'
``wi_kernel`` / ``wi_bias`` / ``wo_kernel`` / ``wo_bias`` stacked on axis 1.
An Imagen stage's U-Net: ``imagen_params_from_jax`` / ``check_imagen_tree``
against ``models/imagen/unet.py`` (JAX's names; the convolution and
attention kernels converted to the port's layouts once).
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.model import GPTConfig, param_shapes


def _to_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes leaf: numpy has no bf16
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: device_get leaves are read-only, torch tensors are not
    return torch.from_numpy(np.array(arr)).to(device)


def _walk(node: Any, want: Any, path: str, leaf) -> Any:
    """``want``'s nesting with ``leaf(node)`` at each leaf; raises
    ``ValueError`` on a missing or extra leaf or a shape mismatch."""
    if isinstance(want, dict):
        if not isinstance(node, Mapping):
            raise ValueError(f"{path or '<root>'}: expected a subtree, "
                             f"got {type(node).__name__}")
        missing = sorted(set(want) - set(node))
        extra = sorted(set(node) - set(want))
        if missing or extra:
            raise ValueError(f"{path or '<root>'}: missing leaves "
                             f"{missing}, unexpected leaves {extra}")
        return {k: _walk(node[k], want[k], f"{path}/{k}".lstrip("/"), leaf)
                for k in want}
    shape = tuple(getattr(node, "shape", None) or np.shape(node))
    if shape != tuple(want):
        raise ValueError(f"{path}: shape {shape} != expected "
                         f"{tuple(want)}")
    return leaf(node)


def _expected(tree: Mapping, cfg: GPTConfig) -> dict:
    """``param_shapes(cfg)`` plus the shapes of the adapter pairs
    ``tree`` carries beside the LoRA target kernels."""
    from fleetx_tpu_torch.finetune import lora

    want = param_shapes(cfg)

    def walk(w: dict, node: Any, path: str) -> None:
        if not isinstance(node, Mapping):
            return
        for key, value in list(w.items()):
            full = f"{path}/{key}".lstrip("/")
            if isinstance(value, dict):
                walk(value, node.get(key), full)
                continue
            target = lora.target_of(full)
            a = node.get(key + "_lora_a")
            if target is None or a is None:
                continue
            rank = (getattr(a, "shape", None) or np.shape(a))[-1]
            w[key + "_lora_a"], w[key + "_lora_b"] = lora.adapter_shapes(
                value, rank, target)

    walk(want, tree, "")
    return want


def check_tree(tree: Mapping, cfg: GPTConfig) -> None:
    """Structure and shape checks of ``params_from_jax`` alone."""
    _walk(tree, _expected(tree, cfg), "", lambda node: None)


def params_from_jax(tree: Mapping, cfg: GPTConfig,
                    device: Union[str, torch.device] = "cpu") -> dict:
    """Convert an unboxed numpy param tree; raises ``ValueError`` on any
    structural or shape mismatch."""
    device = torch.device(device)
    return _walk(tree, _expected(tree, cfg), "",
                 lambda node: _to_tensor(node, device))


def check_ernie_tree(tree: Mapping, cfg) -> None:
    """``check_tree`` for an ERNIE tree (``ErnieConfig``)."""
    from fleetx_tpu_torch.models.ernie.model import param_shapes as shapes

    _walk(tree, shapes(cfg), "", lambda node: None)


def ernie_params_from_jax(tree: Mapping, cfg,
                          device: Union[str, torch.device] = "cpu") -> dict:
    """``params_from_jax`` for the JAX ``ErnieForPretraining`` tree."""
    from fleetx_tpu_torch.models.ernie.model import param_shapes as shapes

    device = torch.device(device)
    return _walk(tree, shapes(cfg), "", lambda node: _to_tensor(node, device))


def check_vit_tree(tree: Mapping, cfg) -> None:
    """``check_tree`` for a ViT tree (``ViTConfig``)."""
    from fleetx_tpu_torch.models.vision.vit import param_shapes as shapes

    _walk(tree, shapes(cfg), "", lambda node: None)


def vit_params_from_jax(tree: Mapping, cfg,
                        device: Union[str, torch.device] = "cpu") -> dict:
    """``params_from_jax`` for the JAX ``ViT`` tree."""
    from fleetx_tpu_torch.models.vision.vit import param_shapes as shapes

    device = torch.device(device)
    return _walk(tree, shapes(cfg), "", lambda node: _to_tensor(node, device))


def check_imagen_tree(tree: Mapping, cfg, lowres_time: bool = False,
                      jax_layout: bool = True) -> None:
    """``check_tree`` for an Imagen stage's tree, its U-Net under ``unet``
    (``UNetConfig``; with ``lowres_time`` it holds ``lowres_time_mlp``):
    against JAX's layouts, or the port's with ``jax_layout=False``."""
    from fleetx_tpu_torch.models.imagen import unet as U

    shapes = U.jax_param_shapes if jax_layout else U.param_shapes
    _walk(tree, {"unet": shapes(cfg, lowres_time)}, "", lambda node: None)


def imagen_params_from_jax(tree: Mapping, cfg, lowres_time: bool = False,
                           device: Union[str, torch.device] = "cpu") -> dict:
    """``params_from_jax`` for the JAX ``ImagenStage`` tree (its U-Net
    under ``unet``): flax's names kept, each HWIO convolution kernel
    made OHWI and each ``DenseGeneral`` attention projection made 2-D,
    once (``models/imagen/unet.py``)."""
    from fleetx_tpu_torch.models.imagen import unet as U

    device = torch.device(device)
    checked = _walk(tree, {"unet": U.jax_param_shapes(cfg, lowres_time)},
                    "", lambda node: node)

    def convert(path: tuple, leaf) -> torch.Tensor:
        return _to_tensor(U.to_port_leaf(path, np.asarray(leaf)), device)

    return U.map_leaves(checked, convert)
