"""masklab_tpu_torch: the PyTorch / CUDA port of masklab_tpu.

MaskLab (RetinaMask detection and instance masks joined with a DeepLab V3+
semantic head over a shared backbone) for NVIDIA Hopper. The JAX package
``masklab_tpu`` beside it is the reference; this package imports nothing of
it, nor JAX. Convolutions and matrix products run on stock PyTorch; the
three TPU kernels of the reference are hand-written CUDA kernels under
``csrc/`` (see ``ops/cuda``), built with nvcc at first use.

Entry points (``build_masklab``, ``MaskLabPredictor``) run on the CUDA card
unless the caller passes ``device='cpu'``; the servers and
``process_folder`` (``serving``) take a predictor.
"""
from .config import ModelConfiguration
from .device import resolve_device
from .models.masklab import MaskLab, build_masklab
from .presets import road_project_config
from .prior import PriorBoxes, generate_priors, priors_from_config
from .serving.predictor import MaskLabPredictor
from .weights import force_dense, init_weights, load_flax_variables

__version__ = '0.1.0'

__all__ = ['ModelConfiguration', 'MaskLab', 'build_masklab',
           'MaskLabPredictor', 'load_flax_variables', 'init_weights',
           'force_dense', 'resolve_device', 'road_project_config',
           'PriorBoxes', 'generate_priors', 'priors_from_config',
           '__version__']
