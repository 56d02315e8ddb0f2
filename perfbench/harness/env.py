"""The run's environment: fixed cache directories inside the checkout, the
card check, and the check that no JAX module was loaded."""
from __future__ import annotations

import os
import sys
from typing import List

from .spec import PERFBENCH

CACHE = os.path.join(PERFBENCH, '_cache')
# top-level module names the port's runs may not load (compared whole:
# ``masklab_tpu_torch`` is the port itself)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'masklab_tpu')


def set_cache_dirs() -> None:
    """Every compile cache under ``perfbench/_cache`` at a fixed path, so
    only a checkout's first run builds; set before torch is imported.
    ``USE_FLAX=0`` keeps any library that would load flax from doing so."""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'nv_compute')):
        path = os.path.join(CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ['USE_FLAX'] = '0'
    # the program's OpenMP pool takes half of the machine's 8 cores (PyTorch
    # would take all 8), the rest left to the trainer's prefetch thread and
    # the data generator's cv2 pool; measured against the default in both
    # cells (PERF.md section 2)
    os.environ['OMP_NUM_THREADS'] = '4'


def kernel_build_dir() -> str:
    """Where the port builds and finds its CUDA library
    (``utils.profiling.enable_compilation_cache``)."""
    path = os.path.join(CACHE, 'cuda_kernels')
    os.makedirs(path, exist_ok=True)
    return path


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def card_problem(chips: int) -> str:
    """Why this machine cannot run a cell of ``chips`` cards ('' if it
    can)."""
    import torch
    if not torch.cuda.is_available():
        return 'torch.cuda.is_available() is false'
    if torch.cuda.device_count() < chips:
        return (f'{torch.cuda.device_count()} CUDA device(s), the cell asks '
                f'for {chips}')
    return ''
