"""Model families of the port (GPT and its MoE stack, ERNIE, ViT,
Imagen) and the module registry
(port of ``fleetx_tpu/models/__init__.py:12-54``)."""

from __future__ import annotations

__all__ = ["build_module", "get_registry"]


def get_registry() -> dict:
    """Name → task-module class (imported on the first call, not with the
    package)."""
    from fleetx_tpu_torch.core.module import (GPTEvalModule,
                                              GPTGenerationModule, GPTModule)
    from fleetx_tpu_torch.finetune.module import LoRAGPTModule
    from fleetx_tpu_torch.models.ernie.module import ErnieModule
    from fleetx_tpu_torch.models.imagen.module import ImagenModule
    from fleetx_tpu_torch.models.vision.module import GeneralClsModule

    return {"GPTModule": GPTModule, "GPTEvalModule": GPTEvalModule,
            "GPTGenerationModule": GPTGenerationModule,
            "LoRAGPTModule": LoRAGPTModule, "ErnieModule": ErnieModule,
            "GeneralClsModule": GeneralClsModule,
            "ImagenModule": ImagenModule}


#: modules of the JAX registry still to port → their ROADMAP port queue
#: item (every module of the JAX registry is ported)
NOT_PORTED: dict = {}


def build_module(cfg):
    """Instantiate the task module named by ``cfg.Model.module``."""
    name = (cfg.get("Model") or {}).get("module", "GPTModule")
    if name in NOT_PORTED:
        raise NotImplementedError(f"module {name} is not ported yet "
                                  f"(ROADMAP.md, port queue item "
                                  f"{NOT_PORTED[name]})")
    modules = get_registry()
    if name not in modules:
        raise ValueError(f"unknown module {name!r}; have {sorted(modules)}")
    return modules[name](cfg)
