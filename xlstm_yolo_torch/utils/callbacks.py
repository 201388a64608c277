"""The callback registry of the trainer, validator and predictor.

Port of ``HOOKS``, ``Callbacks`` and ``default_callbacks`` in
``xlstm_yolo_tpu/utils/callbacks.py``, without its logger integrations.
"""
from __future__ import annotations

from collections import defaultdict

HOOKS = (
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
    "on_train_epoch_start", "on_train_batch_start", "optimizer_step",
    "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "on_params_update",
    "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end",
    "on_predict_batch_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
)


class Callbacks:
    """Functions registered per hook, called in registration order."""

    def __init__(self):
        self._cbs: dict[str, list] = defaultdict(list)

    def add(self, hook: str, fn) -> None:
        if hook not in HOOKS:
            raise KeyError(f"unknown hook {hook!r}")
        self._cbs[hook].append(fn)

    def run(self, hook: str, *args, **kwargs) -> None:
        for fn in self._cbs.get(hook, []):
            fn(*args, **kwargs)

    def merge(self, integration: dict) -> None:
        for hook, fn in integration.items():
            self.add(hook, fn)


def default_callbacks() -> Callbacks:
    return Callbacks()
