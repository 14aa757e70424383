"""Card peak-FLOPs table and the GPT FLOPs count for MFU reporting.

Port of ``fleetx_tpu/utils/hardware.py:11-18, 67-73, 103-115``, with the
TPU table replaced by NVIDIA cards. Peaks are the dense bf16 tensor-core
rates of NVIDIA's data sheets (no sparsity), at the card's full power
limit: a card set below it runs slower under load.
"""

from __future__ import annotations

from typing import Optional

# substring of torch.cuda.get_device_name (lowercased) -> bf16 dense FLOP/s
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),   # SXM
)


def peak_flops(device_name: str) -> Optional[float]:
    """bf16 dense peak of a card by its name, None when unknown."""
    name = (device_name or "").lower()
    for key, peak in PEAK_FLOPS:
        if key in name:
            return peak
    return None


def gpt_flops_per_token(num_layers: int, hidden_size: int, seq_len: int,
                        num_params: Optional[int] = None,
                        vocab_size: Optional[int] = None) -> float:
    """PaLM-style fwd+bwd FLOPs per trained token: ``6N + 12·L·H·S``; ``N``
    from the architecture when not given (``language_module.py:102-105``)."""
    if num_params is None:
        num_params = int(num_layers * 12 * hidden_size * hidden_size
                         + (vocab_size or 0) * hidden_size)
    return 6.0 * num_params + 12.0 * num_layers * hidden_size * seq_len
