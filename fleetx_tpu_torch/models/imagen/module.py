"""Imagen task module (port of ``fleetx_tpu/models/imagen/module.py``).

Trains ONE cascade stage per run, as the recipes do: the base 64² stage
or a super-resolution stage, by ``Model.preset``. Batches carry
``images`` (NHWC, [-1, 1]), ``text_embeds`` / ``text_mask`` (precomputed
T5 features) and, for SR stages, ``lowres_images``. A step's randomness
(the timesteps, the noise, the CFG dropout, the low-res augmentation and
the U-Net's dropout) comes from one generator seeded by ``Global.seed``
with the step folded in (``models/gpt/model.dropout_rng``), as JAX folds
the step into its key; the draws are JAX's in distribution, not in bits.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from fleetx_tpu_torch.core.module import BasicModule
from fleetx_tpu_torch.models.gpt.model import dropout_rng
from fleetx_tpu_torch.models.imagen import unet as U
from fleetx_tpu_torch.models.imagen.modeling import build_stage
from fleetx_tpu_torch.parallel.sharding import DATA_AXES, data_mean
from fleetx_tpu_torch.utils.log import logger


class ImagenModule(BasicModule):
    """Cascade-stage training task."""

    #: the JAX module's partition-rule family (the stages are
    #: data-parallel only)
    spec_family = "imagen"

    def __init__(self, cfg: Any):
        model_cfg = dict(cfg.get("Model", cfg)) if isinstance(cfg, dict) \
            else {}
        self.model_dict = model_cfg
        self.stage = build_stage(model_cfg)
        super().__init__(cfg)
        logger.info("Imagen stage: preset=%s image=%s lowres_cond=%s",
                    model_cfg.get("preset"), model_cfg.get("image_size"),
                    self.stage.unet_cfg.lowres_cond)

    @property
    def model_cfg(self) -> U.UNetConfig:
        """The U-Net config, under the name the engine reads."""
        return self.stage.unet_cfg

    def init_params(self, seed: int, device) -> dict:
        """Seeded parameters in the port's layout on ``device``, the
        U-Net's under ``unet``."""
        return {"unet": U.init_params(self.stage.unet_cfg,
                                      self.stage.lowres_time, seed=seed,
                                      device=device)}

    def check_params(self, params: dict) -> None:
        """Raise unless ``params`` has this stage's tree (port layout)."""
        from fleetx_tpu_torch.convert import check_imagen_tree

        check_imagen_tree(params, self.stage.unet_cfg,
                          self.stage.lowres_time, jax_layout=False)

    @staticmethod
    def _inputs(batch: dict):
        return (batch["images"], batch.get("text_embeds"),
                batch.get("text_mask"), batch.get("lowres_images"))

    def training_loss(self, params: dict, batch: dict, seed: int,
                      step: int):
        """``(loss, {"loss"})`` with the CFG dropout and the U-Net's
        dropout on."""
        images, te, tm, lowres = self._inputs(batch)
        rng = dropout_rng(seed, step, 0, images.device, self.shard)
        loss = self.stage.loss(params, images, te, tm, lowres,
                               deterministic=False, gen=rng.gen, rng=rng,
                               rows=rng.row_block(images.shape[0]))
        loss = data_mean(loss, self.shard)
        return loss, {"loss": loss}

    def validation_loss(self, params: dict, batch: dict):
        """``(loss, {"loss"})`` without dropout, its draws from a generator
        seeded 0 (JAX: ``PRNGKey(0)``)."""
        images, te, tm, lowres = self._inputs(batch)
        gen = torch.Generator(device=images.device)
        gen.manual_seed(0)
        rows = {} if self.shard is None else {0: self.shard.block(
            DATA_AXES, images.shape[0])}
        loss = data_mean(self.stage.loss(params, images, te, tm, lowres,
                                         deterministic=True, gen=gen,
                                         rows=rows), self.shard)
        return loss, {"loss": loss}

    def sample_images(self, params: dict, batch_size: int,
                      text_embeds=None, text_mask=None, lowres_images=None,
                      generator: Optional[torch.Generator] = None,
                      **noises) -> torch.Tensor:
        """``[batch_size, image_size, image_size, channels]`` images in
        [-1, 1] from this stage; ``noises`` (``init_noise``,
        ``step_noises``) replace the generator's draws."""
        size = int(self.model_dict.get("image_size", 64))
        shape = (batch_size, size, size, self.stage.unet_cfg.channels)
        return self.stage.sample(params, shape, text_embeds, text_mask,
                                 lowres_images, gen=generator, **noises)

    def training_step_end(self, log_dict: dict) -> None:
        speed = 1.0 / max(log_dict.get("train_cost", 1e-9), 1e-9)
        ips = log_dict.get("global_batch_size", 1) * speed
        logger.info(
            "[train] global step %d, loss: %.6f, avg_batch_cost: %.5f sec, "
            "ips: %.1f images/s, learning rate: %.5e",
            log_dict["global_step"], log_dict["loss"],
            log_dict.get("train_cost", 0.0), ips, log_dict.get("lr", 0.0))
