"""Abstract engine protocol (port of
``fleetx_tpu/core/engine/basic_engine.py``)."""

from __future__ import annotations

from typing import Any, Iterable, Optional


class BasicEngine:
    """The engine surface every trainer implements."""

    def fit(self, train_data_loader: Iterable, valid_data_loader=None,
            epoch_num: int = 1):
        raise NotImplementedError

    def evaluate(self, valid_data_loader: Iterable, global_step: int = 0):
        raise NotImplementedError

    def predict(self, data: Any):
        raise NotImplementedError

    def save(self):
        raise NotImplementedError

    def load(self, directory: Optional[str] = None):
        raise NotImplementedError

    def inference(self, data: Any):
        raise NotImplementedError
