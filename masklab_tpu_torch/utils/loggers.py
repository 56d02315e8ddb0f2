"""Training observability: CSV, TensorBoard, and optional MLflow sinks.

The port's own copy of ``masklab_tpu/utils/loggers.py``: CSVLogger, the
TensorBoard scalar writer (PyTorch's, where the reference writes through
tensorflow), and MLflow params / metrics / artifacts. Each sink degrades to
a no-op when its package is unavailable.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional


class CSVLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._writer = None
        self._file = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {'step': step, **{k: float(v) for k, v in metrics.items()}}
        if self._writer is None:
            self._file = open(self.path, 'w', newline='')
            self._writer = csv.DictWriter(self._file,
                                          fieldnames=list(row))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


class TensorBoardLogger:
    """Scalar writer (the reference's TensorBoard callback):
    ``torch.utils.tensorboard.SummaryWriter``, a no-op when the
    ``tensorboard`` package is absent."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), global_step=step)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


class MLflowLogger:
    """Optional MLflow sink (the original project's train script logged
    params, metrics and artifacts). No-op if mlflow is absent."""

    def __init__(self, run_name: Optional[str] = None):
        try:
            import mlflow  # noqa: PLC0415
        except ImportError:
            self._mlflow = None
        else:
            self._mlflow = mlflow
            mlflow.start_run(run_name=run_name)

    def log_params(self, params: Dict) -> None:
        if self._mlflow:
            for k, v in params.items():
                self._mlflow.log_param(k, v)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._mlflow:
            for k, v in metrics.items():
                self._mlflow.log_metric(k, float(v), step=step)

    def log_artifact(self, path: str) -> None:
        if self._mlflow:
            self._mlflow.log_artifact(path)

    def log_artifact_dir(self, path: str, name: Optional[str] = None) -> None:
        """A whole directory (a checkpoint: the original project logged its
        best weights file into the run)."""
        if self._mlflow:
            self._mlflow.log_artifacts(path, artifact_path=name)

    def close(self):
        if self._mlflow:
            self._mlflow.end_run()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for l in self.loggers:
            l.log(step, metrics)

    def close(self):
        for l in self.loggers:
            l.close()
