"""Imagen cascade sampler (port of ``tasks/imagen/generate.py``)::

    python -m fleetx_tpu_torch.tasks.imagen.generate \
        -c fleetx_tpu/configs/multimodal/imagen/imagen_397M_text2im_64x64.yaml \
        -o Generation.stage_configs='["fleetx_tpu/configs/multimodal/imagen/imagen_super_resolution_256.yaml"]' \
        -o Generation.batch_size=2 [--device cuda|cpu]

Builds each stage from its config: the base stage from ``-c`` (with the
``-o`` overrides) and one SR stage per ``Generation.stage_configs`` entry,
read as it is, as the JAX driver reads it. A stage's params come from the
newest checkpoint
under its ``Engine.save_load.ckpt_dir``, verified; with none configured
or present there, it warns and uses seeded random weights (``Global.seed``
of that stage's config). The base stage samples from text features drawn
with ``np.random.RandomState(Global.seed)`` (``[batch, 8,
text_embed_dim]``, all tokens real), and each SR stage samples with the
previous stage's output as its ``lowres_images``. The images are saved
as numpy (``Generation.output_path``, default ``./imagen_samples.npy``).
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np


def load_config(path: str, overrides: Optional[list] = None):
    """The YAML at ``path`` with dotted overrides, post-processed."""
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(path, overrides)


def load_stage(cfg: dict, device):
    """``(module, params)`` of one stage: its checkpoint, or seeded
    weights with a warning."""
    from fleetx_tpu_torch.core.checkpoint import latest_step, load_params
    from fleetx_tpu_torch.models.imagen.module import ImagenModule
    from fleetx_tpu_torch.utils.log import logger

    module = ImagenModule(cfg)
    ckpt_dir = ((cfg.get("Engine") or {}).get("save_load") or {}).get(
        "ckpt_dir")
    if ckpt_dir and latest_step(str(ckpt_dir)) is not None:
        params = load_params(str(ckpt_dir), device=device)
        module.check_params(params)
    else:
        logger.warning("no checkpoint for stage (ckpt_dir=%r): using random "
                       "weights", ckpt_dir)
        seed = int((cfg.get("Global") or {}).get("seed", 0))
        params = module.init_params(seed, device)
    return module, params


def sample_cascade(stages: list, batch_size: int, text_embeds, text_mask,
                   generator=None, on_stage=None):
    """The base stage, then each SR stage conditioned on the previous
    output; ``on_stage(i, images)`` after each stage."""
    from fleetx_tpu_torch.utils.log import logger

    images = None
    for i, (module, params) in enumerate(stages):
        kwargs = {}
        if module.stage.unet_cfg.lowres_cond:
            if images is None:
                raise ValueError("the first stage cannot be an SR stage")
            kwargs["lowres_images"] = images
        images = module.sample_images(params, batch_size,
                                      text_embeds=text_embeds,
                                      text_mask=text_mask,
                                      generator=generator, **kwargs)
        logger.info("stage sampled: %s", tuple(images.shape))
        if on_stage is not None:
            on_stage(i, images)
    return images


def run(cfg: dict, device=None):
    """Sample the cascade ``cfg`` describes; the final images (a tensor on
    the device)."""
    import torch

    from fleetx_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    gen_cfg = dict(cfg.get("Generation") or {})
    batch_size = int(gen_cfg.get("batch_size", 1))
    stages = [load_stage(cfg, device)]
    for path in list(gen_cfg.get("stage_configs") or []):
        stages.append(load_stage(load_config(path), device))
    text_dim = stages[0][0].stage.unet_cfg.text_embed_dim
    seed = int((cfg.get("Global") or {}).get("seed", 0))
    rng = np.random.RandomState(seed)
    text_embeds = torch.from_numpy(rng.randn(batch_size, 8, text_dim)
                                   .astype(np.float32)).to(device)
    text_mask = torch.ones((batch_size, 8), dtype=torch.int32,
                           device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return sample_cascade(stages, batch_size, text_embeds, text_mask,
                          generator)


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import parse_args
    from fleetx_tpu_torch.utils.log import logger

    args = parse_args("fleetx_tpu_torch imagen generate", argv)
    cfg = load_config(args.config, args.override)
    images = run(cfg, device=args.device).cpu().numpy()
    out = (cfg.get("Generation") or {}).get("output_path",
                                            "./imagen_samples.npy")
    np.save(out, images)
    logger.info("wrote %s: %s in [%.3f, %.3f]", out, images.shape,
                float(images.min()), float(images.max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
