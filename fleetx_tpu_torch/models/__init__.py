"""Model families of the port (GPT so far) and the module registry
(port of ``fleetx_tpu/models/__init__.py:46-54``)."""

from __future__ import annotations

__all__ = ["build_module"]


def build_module(cfg):
    """Instantiate the task module named by ``cfg.Model.module``:
    ``GPTModule``, ``GPTEvalModule``, ``GPTGenerationModule`` or
    ``LoRAGPTModule`` (the other families: ROADMAP.md, port queue item
    7)."""
    from fleetx_tpu_torch.core import module as modules

    name = (cfg.get("Model") or {}).get("module", "GPTModule")
    if name == "LoRAGPTModule":
        from fleetx_tpu_torch.finetune.module import LoRAGPTModule

        return LoRAGPTModule(cfg)
    if name not in ("GPTModule", "GPTEvalModule", "GPTGenerationModule"):
        raise NotImplementedError(f"module {name} is not ported yet "
                                  f"(ROADMAP.md, port queue item 7)")
    return getattr(modules, name)(cfg)
