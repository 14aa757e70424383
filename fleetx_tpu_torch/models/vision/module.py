"""Image-classification task module (port of
``fleetx_tpu/models/vision/module.py:24-88``): the ViT config from the
preset named by ``Model.name`` with the YAML's overrides, the smoothed
training loss, the eval loss with top-k accuracy, and the images/s log
line."""

from __future__ import annotations

from typing import Any

from fleetx_tpu_torch.core.module import BasicModule
from fleetx_tpu_torch.models.gpt.model import dropout_rng
from fleetx_tpu_torch.models.vision import loss as L
from fleetx_tpu_torch.models.vision import vit as V
from fleetx_tpu_torch.parallel.sharding import data_mean
from fleetx_tpu_torch.utils.log import logger

#: ``Model`` keys that override the preset
_OVERRIDES = ("num_classes", "image_size", "patch_size", "num_layers",
              "hidden_size", "num_attention_heads", "mlp_ratio",
              "drop_path_rate", "dtype", "param_dtype", "use_recompute",
              "scan_layers")


class GeneralClsModule(BasicModule):
    """Classification: ``training_loss`` (dropout and DropPath on, the
    ``Model.loss.epsilon`` smoothing) and ``validation_loss`` (off, no
    smoothing, with ``top<k>`` for ``Model.metric.topk``)."""

    #: the partition-rule family (``parallel/rules.py``)
    spec_family = "vision"

    def __init__(self, cfg: Any):
        model_cfg = dict(cfg.get("Model", cfg) if isinstance(cfg, dict)
                         else cfg)
        name = model_cfg.get("name", "ViT_base_patch16_224")
        preset = dict(V.PRESETS.get(name) or {})
        if isinstance(model_cfg.get("model"), dict):
            preset.update({k: v for k, v in model_cfg["model"].items()
                           if v is not None})
        for key in _OVERRIDES:
            if model_cfg.get(key) is not None:
                preset[key] = model_cfg[key]
        self.vit_cfg = V.config_from_dict(preset)
        loss_cfg = dict(model_cfg.get("loss") or {})
        self.label_smoothing = float(loss_cfg.get(
            "epsilon", loss_cfg.get("label_smoothing", 0.0)))
        topk = (model_cfg.get("metric") or {}).get("topk", (1, 5))
        self.topk = tuple(int(k) for k in topk)
        super().__init__(cfg)
        c = self.vit_cfg
        logger.info("ViT model: layers=%d hidden=%d heads=%d classes=%d",
                    c.num_layers, c.hidden_size, c.num_attention_heads,
                    c.num_classes)

    @property
    def model_cfg(self) -> V.ViTConfig:
        """``vit_cfg``, under the name the engine reads."""
        return self.vit_cfg

    def init_params(self, seed: int, device) -> dict:
        """Seeded parameters in the JAX layout on ``device``."""
        return V.init_params(self.vit_cfg, seed=seed, device=device)

    def check_params(self, params: dict) -> None:
        """Raise unless ``params`` has the tree of this config."""
        from fleetx_tpu_torch.convert import check_vit_tree

        check_vit_tree(params, self.vit_cfg)

    def training_loss(self, params: dict, batch: dict, seed: int,
                      step: int):
        """``(loss, {"loss"})`` with dropout and DropPath on, their
        randomness from ``seed`` with ``step`` folded in."""
        rng = dropout_rng(seed, step, self.vit_cfg.num_layers,
                          batch["images"].device, self.shard)
        logits = V.vit(params, self.vit_cfg, batch["images"],
                       deterministic=False, rng=rng)
        loss = data_mean(L.vit_cross_entropy(logits, batch["labels"],
                                             self.label_smoothing),
                         self.shard)
        return loss, {"loss": loss}

    def validation_loss(self, params: dict, batch: dict):
        """``(loss, {"loss", "top<k>"...})`` with dropout off and no
        smoothing."""
        logits = V.vit(params, self.vit_cfg, batch["images"])
        loss = data_mean(L.cross_entropy(logits, batch["labels"]),
                         self.shard)
        metrics = {"loss": loss}
        metrics.update({k: data_mean(v, self.shard) for k, v in
                        L.topk_accuracy(logits, batch["labels"],
                                        self.topk).items()})
        return loss, metrics

    def training_step_end(self, log_dict: dict) -> None:
        speed = 1.0 / max(log_dict.get("train_cost", 1e-9), 1e-9)
        ips = log_dict.get("global_batch_size", 1) * speed
        logger.info(
            "[train] global step %d, epoch: %d, batch: %d, loss: %.9f, "
            "avg_batch_cost: %.5f sec, speed: %.2f step/s, ips: %.1f "
            "images/s, learning rate: %.5e", log_dict["global_step"],
            log_dict.get("epoch", 0), log_dict["batch"], log_dict["loss"],
            log_dict.get("train_cost", 0.0), speed, ips,
            log_dict.get("lr", 0.0))
