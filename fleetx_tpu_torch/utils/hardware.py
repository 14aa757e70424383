"""Card peak tables, the roofline and the GPT FLOPs count for MFU
reporting.

Port of ``fleetx_tpu/utils/hardware.py:11-41, 67-115``, with the TPU
tables replaced by NVIDIA cards. Peaks are the dense bf16 tensor-core
rates of NVIDIA's data sheets (no sparsity) and the HBM rates of the same
sheets, at the card's full power limit: a card set below it runs slower
under load.
"""

from __future__ import annotations

from typing import Optional

# substring of torch.cuda.get_device_name (lowercased) -> bf16 dense FLOP/s
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),   # SXM
)


# substring of torch.cuda.get_device_name (lowercased) -> HBM bytes/s (the
# roofline's bandwidth axis beside PEAK_FLOPS' compute axis)
HBM_BANDWIDTH = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),  # SXM, HBM3
)

# What a card sustains, measured by ``chip_smoke.py`` phase 17 (the median
# of 10 CUDA-event timings of a bf16 8192^3 matmul, and of a 1 GiB
# device-to-device copy counting the bytes read and written): the trace
# decomposition's roofline scores the matmul time against it. Keyed like
# PEAK_FLOPS; ``card`` is the name and power limit nvidia-smi reported.
CALIBRATED_ROOFLINE = {
    "h100 80gb hbm3": {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "rates": {"matmul_flops": 748627115364992.4,
                  "hbm_bytes_per_s": 2976266765259.0884}},
}


def peak_flops(device_name: str) -> Optional[float]:
    """bf16 dense peak of a card by its name, None when unknown."""
    name = (device_name or "").lower()
    for key, peak in PEAK_FLOPS:
        if key in name:
            return peak
    return None


def roofline(device_name: str) -> Optional[dict]:
    """``{"peak_flops", "matmul_flops", "hbm_bytes_per_s"}`` of a card by
    its name: ``peak_flops`` the data sheet's (the MFU denominator),
    ``matmul_flops`` / ``hbm_bytes_per_s`` the calibrated rates where
    ``CALIBRATED_ROOFLINE`` has them, else the data sheet's. None for a
    name in no table (the CPU)."""
    name = (device_name or "").lower()
    peak = peak_flops(name)
    if peak is None:
        return None
    bandwidth = next((b for k, b in HBM_BANDWIDTH if k in name), None)
    out = {"peak_flops": peak, "matmul_flops": peak,
           "hbm_bytes_per_s": bandwidth}
    # the longest key that matches wins, as in peak_flops
    for key in sorted(CALIBRATED_ROOFLINE, key=len, reverse=True):
        if key in name:
            out.update(CALIBRATED_ROOFLINE[key]["rates"])
            break
    return out


def gpt_flops_per_token(num_layers: int, hidden_size: int, seq_len: int,
                        num_params: Optional[int] = None,
                        vocab_size: Optional[int] = None) -> float:
    """PaLM-style fwd+bwd FLOPs per trained token: ``6N + 12·L·H·S``; ``N``
    from the architecture when not given (``language_module.py:102-105``)."""
    if num_params is None:
        num_params = int(num_layers * 12 * hidden_size * hidden_size
                         + (vocab_size or 0) * hidden_size)
    return 6.0 * num_params + 12.0 * num_layers * hidden_size * seq_len
