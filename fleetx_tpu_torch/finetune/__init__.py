"""Parameter-efficient fine-tuning (port of ``fleetx_tpu/finetune/``).

LoRA adapters from a pretrain checkpoint to quantized serving: adapter
injection over the target matmuls (``lora.py``), the ``LoRAGPTModule``
task recipe (``module.py``), the verified adapter-only artifact
(``checkpoint.py``) and the end-to-end orchestration (``recipe.py``).
"""

from fleetx_tpu_torch.finetune.checkpoint import (AdapterDriftError,
                                                  apply_adapter_checkpoint,
                                                  load_adapter,
                                                  save_adapter)
from fleetx_tpu_torch.finetune.lora import (adapter_mask, inject_adapters,
                                            lora_optimizer, merge_adapters,
                                            split_adapters,
                                            trainable_params_frac)
from fleetx_tpu_torch.finetune.module import LoRAGPTModule

__all__ = [
    "AdapterDriftError", "LoRAGPTModule", "adapter_mask",
    "apply_adapter_checkpoint", "inject_adapters", "load_adapter",
    "lora_optimizer", "merge_adapters", "save_adapter", "split_adapters",
    "trainable_params_frac",
]
