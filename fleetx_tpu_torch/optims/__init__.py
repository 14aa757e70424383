"""Optimizers and LR schedules (port of ``fleetx_tpu/optims/``)."""

from fleetx_tpu_torch.optims.lr_scheduler import (  # noqa: F401
    build_lr_scheduler,
    constant_lr,
    cosine_annealing_with_warmup,
    vit_lr,
)
from fleetx_tpu_torch.optims.optimizer import (  # noqa: F401
    AdamW,
    Momentum,
    build_optimizer,
    decay_mask,
    is_no_decay_path,
)
