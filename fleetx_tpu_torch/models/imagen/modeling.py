"""Imagen: text-to-image cascaded diffusion, one stage at a time.

Port of ``fleetx_tpu/models/imagen/modeling.py``: ``DiffusionConfig``
(:31-43), ``make_schedule`` (:46-69, numpy f64 then f32 tables, as in
JAX), ``q_sample``, ``predict_x0``, ``dynamic_threshold`` (:72-95),
``ImagenStage``'s training loss (:114-164) and ancestral DDPM ``sample``
with classifier-free guidance and dynamic thresholding (:166-214),
``UNET_PRESETS`` and ``build_stage`` (:219-244).

The randomness comes from an explicit ``torch.Generator``: the loss draws
the timesteps, the noise, the CFG conditioning dropout and the SR
stages' low-res augmentation noise from it, in that order, and ``sample``
its initial noise and one noise a step. Each draw can also be passed in
as a tensor (``t``, ``noise``, ``cond_drop``, ``aug_noise``;
``init_noise``, ``step_noises``): the functions are JAX's, the bits of
``jax.random`` are not torch's, so the tests feed JAX's draws through
these arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.model import DropoutRng
from fleetx_tpu_torch.models.imagen import unet as U
from fleetx_tpu_torch.parallel.sharding import global_draw


@dataclasses.dataclass
class DiffusionConfig:
    """Per-stage diffusion hyperparameters."""

    timesteps: int = 1000
    schedule: str = "cosine"          # cosine | linear
    pred_type: str = "eps"            # eps | v
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    cond_drop_prob: float = 0.1        # CFG conditioning dropout
    guidance_scale: float = 5.0        # sampling-time CFG weight
    dynamic_threshold_pct: float = 0.95
    lowres_noise_aug: float = 0.1      # SR-stage conditioning augmentation


def make_schedule(cfg: DiffusionConfig) -> dict:
    """The alpha-bar tables, in numpy f64 and stored f32 (as JAX's)."""
    T = cfg.timesteps
    if cfg.schedule == "cosine":
        s = 0.008
        steps = np.arange(T + 1, dtype=np.float64) / T
        f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
        alpha_bar = np.clip(f / f[0], 1e-8, 1.0)
        betas = np.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
    else:
        betas = np.linspace(1e-4, 0.02, T)
    alphas = 1.0 - betas
    alpha_bar = np.cumprod(alphas)
    prev = np.concatenate([[1.0], alpha_bar[:-1]])
    posterior_var = betas * (1 - prev) / (1 - alpha_bar)
    return {"betas": betas.astype(np.float32),
            "alphas": alphas.astype(np.float32),
            "alpha_bar": alpha_bar.astype(np.float32),
            "alpha_bar_prev": prev.astype(np.float32),
            "posterior_var": posterior_var.astype(np.float32)}


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``table[t]`` broadcast to an image batch of rank ``ndim``."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(schedule: dict, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion: ``x_t | x_0``."""
    ab = _gather(schedule["alpha_bar"], t, x0.dim())
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def predict_x0(schedule: dict, cfg: DiffusionConfig, x_t: torch.Tensor,
               t: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``x0`` from the network's prediction (eps or v objective)."""
    ab = _gather(schedule["alpha_bar"], t, x_t.dim())
    if cfg.pred_type == "v":
        return torch.sqrt(ab) * x_t - torch.sqrt(1.0 - ab) * pred
    return (x_t - torch.sqrt(1.0 - ab) * pred) / torch.sqrt(
        torch.clamp(ab, min=1e-8))


def dynamic_threshold(x0: torch.Tensor, pct: float) -> torch.Tensor:
    """Clip to each sample's ``pct`` quantile of ``|x0|`` (at least 1) and
    rescale into [-1, 1]."""
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), pct, dim=-1)
    s = torch.clamp(s, min=1.0).reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


class ImagenStage:
    """One cascade stage: an ``EfficientUNet`` and its diffusion process;
    the parameters (the U-Net's under ``unet``, as in JAX's tree) are
    passed to each call."""

    def __init__(self, unet_cfg: U.UNetConfig, diff_cfg: DiffusionConfig):
        self.unet_cfg = unet_cfg
        self.diff_cfg = diff_cfg
        self.schedule_np = make_schedule(diff_cfg)
        self._tables: dict = {}

    @property
    def lowres_time(self) -> bool:
        """True when the U-Net embeds the low-res augmentation time (the
        tree then holds ``lowres_time_mlp``)."""
        return self.unet_cfg.lowres_cond and \
            self.diff_cfg.lowres_noise_aug > 0.0

    def schedule(self, device) -> dict:
        """The schedule's tables as f32 tensors on ``device`` (made once
        a device)."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = {k: torch.from_numpy(v).to(device)
                                 for k, v in self.schedule_np.items()}
        return self._tables[key]

    def _lowres_t(self, b: int, device) -> torch.Tensor:
        dc = self.diff_cfg
        return torch.full((b,), int(dc.lowres_noise_aug * dc.timesteps),
                          dtype=torch.long, device=device)

    def loss(self, params: dict, images: torch.Tensor,
             text_embeds: Optional[torch.Tensor] = None,
             text_mask: Optional[torch.Tensor] = None,
             lowres_images: Optional[torch.Tensor] = None, *,
             deterministic: bool = True,
             gen: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             cond_drop: Optional[torch.Tensor] = None,
             aug_noise: Optional[torch.Tensor] = None,
             rng: Optional[DropoutRng] = None,
             rows: Optional[dict] = None) -> torch.Tensor:
        """The stage's training loss (JAX's ``p_losses``): the MSE of the
        prediction against the noise (or v), p2-weighted when
        ``p2_loss_weight_gamma`` is above 0. Draws not passed in come from
        ``gen``; ``rng`` drives the U-Net's dropout. ``rows`` (``{0:
        (offset, total)}``) places a data rank's rows in the global batch,
        whose draws it takes its rows of (``sharding.global_draw``)."""
        dc = self.diff_cfg
        dev = images.device
        b = images.shape[0]
        sched = self.schedule(dev)
        rows = rows or {}

        def randn(shape):
            return global_draw(lambda full: torch.randn(
                full, generator=gen, device=dev), tuple(shape), rows)

        if t is None:
            t = global_draw(lambda full: torch.randint(
                0, dc.timesteps, full, generator=gen, device=dev), (b,), rows)
        if noise is None:
            noise = randn(images.shape)
        x0 = images.float()
        x_t = q_sample(sched, x0, t, noise)
        if text_embeds is not None and not deterministic:
            if cond_drop is None:
                cond_drop = (global_draw(lambda full: torch.rand(
                    full, generator=gen, device=dev), (b,), rows)
                    >= dc.cond_drop_prob).float()
        else:
            cond_drop = None
        lowres_t = None
        if lowres_images is not None and dc.lowres_noise_aug > 0.0:
            lowres_t = self._lowres_t(b, dev)
            if aug_noise is None:
                aug_noise = randn(lowres_images.shape)
            lowres_images = q_sample(sched, lowres_images.float(), lowres_t,
                                     aug_noise)
        pred = U.efficient_unet(params["unet"], self.unet_cfg, x_t, t,
                                text_embeds, text_mask, cond_drop,
                                lowres_images, lowres_t,
                                rng=None if deterministic else rng)
        if dc.pred_type == "v":
            ab = _gather(sched["alpha_bar"], t, images.dim())
            target = torch.sqrt(ab) * noise - torch.sqrt(1.0 - ab) * x0
        else:
            target = noise
        loss = (pred - target) ** 2
        if dc.p2_loss_weight_gamma > 0.0:
            ab = _gather(sched["alpha_bar"], t, images.dim())
            snr = ab / torch.clamp(1.0 - ab, min=1e-8)
            loss = loss * (dc.p2_loss_weight_k + snr) ** (
                -dc.p2_loss_weight_gamma)
        return loss.mean()

    def denoise(self, params: dict, x: torch.Tensor, step: int,
                text_embeds=None, text_mask=None, lowres_images=None,
                lowres_t=None) -> torch.Tensor:
        """One step's thresholded ``x0``: the guided prediction (the
        conditional and unconditional U-Net calls) under CFG."""
        dc = self.diff_cfg
        b = x.shape[0]
        t = torch.full((b,), step, dtype=torch.long, device=x.device)
        run = lambda drop: U.efficient_unet(  # noqa: E731
            params["unet"], self.unet_cfg, x, t, text_embeds, text_mask, drop,
            lowres_images, lowres_t)
        if text_embeds is not None and dc.guidance_scale != 1.0:
            pred_c = run(torch.ones((b,), device=x.device))
            pred_u = run(torch.zeros((b,), device=x.device))
            pred = pred_u + dc.guidance_scale * (pred_c - pred_u)
        else:
            pred = run(None)
        x0 = predict_x0(self.schedule(x.device), dc, x, t, pred)
        return dynamic_threshold(x0, dc.dynamic_threshold_pct)

    @torch.no_grad()
    def sample(self, params: dict, shape: tuple, text_embeds=None,
               text_mask=None, lowres_images=None, *,
               gen: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None,
               step_noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral DDPM from ``T - 1`` down to 0 with CFG and dynamic
        thresholding, clipped to [-1, 1], on the params' device.
        ``step_noises[i]`` is the noise of the i-th step taken (timestep
        ``T - 1 - i``)."""
        dc = self.diff_cfg
        dev = params["unet"]["conv_in"]["kernel"].device
        sched = self.schedule(dev)
        b = shape[0]
        lowres_t = None
        if lowres_images is not None and dc.lowres_noise_aug > 0.0:
            lowres_t = self._lowres_t(b, dev)
        x = init_noise if init_noise is not None else torch.randn(
            shape, generator=gen, device=dev)
        for i, step in enumerate(range(dc.timesteps - 1, -1, -1)):
            x0 = self.denoise(params, x, step, text_embeds, text_mask,
                              lowres_images, lowres_t)
            t = torch.full((b,), step, dtype=torch.long, device=dev)
            ab = _gather(sched["alpha_bar"], t, x.dim())
            ab_prev = _gather(sched["alpha_bar_prev"], t, x.dim())
            beta = _gather(sched["betas"], t, x.dim())
            coef0 = torch.sqrt(ab_prev) * beta / (1.0 - ab)
            coef_t = (torch.sqrt(sched["alphas"][t]).reshape(coef0.shape)
                      * (1.0 - ab_prev) / (1.0 - ab))
            mean = coef0 * x0 + coef_t * x
            var = _gather(sched["posterior_var"], t, x.dim())
            noise = step_noises[i] if step_noises is not None else \
                torch.randn(shape, generator=gen, device=dev)
            x = mean + (torch.sqrt(var) if step > 0 else
                        torch.zeros_like(var)) * noise
        return torch.clamp(x, -1.0, 1.0)


UNET_PRESETS = {
    "base64": dict(dim=128, dim_mults=(1, 2, 3, 4), num_res_blocks=2,
                   layer_attns=(False, False, True, True),
                   layer_cross_attns=(False, True, True, True)),
    "sr256": dict(dim=128, dim_mults=(1, 2, 4, 8), num_res_blocks=2,
                  layer_attns=(False, False, False, True),
                  layer_cross_attns=(False, False, False, True),
                  lowres_cond=True),
    "sr1024": dict(dim=128, dim_mults=(1, 2, 4, 8), num_res_blocks=2,
                   layer_attns=(False, False, False, False),
                   layer_cross_attns=(False, False, False, True),
                   lowres_cond=True),
}


def build_stage(model_cfg: dict) -> ImagenStage:
    """A ``Model`` section → one cascade stage: the preset named by
    ``preset``, overridden by the section's U-Net keys; its diffusion
    keys."""
    preset = dict(UNET_PRESETS.get(model_cfg.get("preset", ""), {}))
    unet_keys = {f.name for f in dataclasses.fields(U.UNetConfig)}
    preset.update({k: v for k, v in model_cfg.items()
                   if k in unet_keys and v is not None})
    diff_keys = {f.name for f in dataclasses.fields(DiffusionConfig)}
    diff = {k: v for k, v in model_cfg.items()
            if k in diff_keys and v is not None}
    return ImagenStage(U.config_from_dict(preset), DiffusionConfig(**diff))
