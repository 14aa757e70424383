"""Device selection shared by the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: a host
without a GPU raises instead of quietly running the CPU path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a GPU present raises. A
    CUDA device without an index gets the current one (``cuda:0``), so it
    compares equal to the device of the tensors made on it."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
