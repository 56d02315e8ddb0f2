"""Training observability: the metric loggers."""
from .loggers import CSVLogger, MLflowLogger, MultiLogger, TensorBoardLogger

__all__ = ['CSVLogger', 'TensorBoardLogger', 'MLflowLogger', 'MultiLogger']
