"""Utilities: profiling and tracing, the metric loggers, host drawing, and
the reference's Keras h5 weights in and out (``keras_import``,
``keras_export``)."""
from .loggers import CSVLogger, MLflowLogger, MultiLogger, TensorBoardLogger
from .profiling import (StageTimer, count, device_trace,
                        enable_compilation_cache, span, timed_blocked)

__all__ = ['StageTimer', 'span', 'count', 'device_trace', 'timed_blocked',
           'enable_compilation_cache', 'CSVLogger', 'TensorBoardLogger',
           'MLflowLogger', 'MultiLogger']
