"""Build and load the port's hand-written CUDA kernels.

The sources in ``masklab_tpu_torch/csrc/`` have a plain C interface. At first
use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one process per
source, all started together, then linked into one shared library under
``masklab_tpu_torch/_build/`` and loaded with ``ctypes``. The library's name
carries a digest of the sources and flags, so an edited source rebuilds and
an unchanged one loads from the earlier build. Nothing here is imported or
built until a wrapper launches a kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')

# source -> extra nvcc flags. nms_keep.cu, paste_stats.cu and
# batch_norm_act.cu must not contract a*b+c into an FMA: the IoU has to
# round exactly like ops/boxes.py iou_yxyx, the paste like its plain
# version's GEMMs, the BatchNorm like PyTorch's separate `* mul` and
# `+ bias` kernels.
SOURCES = {
    'band_groupnorm.cu': [],
    'segment_topk.cu': [],
    'nms_keep.cu': ['-fmad=false'],
    'paste_stats.cu': ['-fmad=false'],
    'batch_norm_act.cu': ['-fmad=false'],
}
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
COMMON_FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    'mlk_band_groupnorm': [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    'mlk_band_groupnorm_backward': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _F, _I, _I, _P],
    'mlk_segment_topk': [_P, _P, _P, _I, _I, _L, _L, _L, _I, _I, _I, _I,
                         _P],
    'mlk_nms_keep': [_P, _P, _P, _I, _I, _F, _I, _P],
    'mlk_nms_keep_build_only': [_P, _P, _P, _I, _I, _F, _I, _P],
    'mlk_nms_keep_smem_bytes': [_I, _I],
    'mlk_nms_keep_init': [],
    'mlk_paste_stats': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    'mlk_batch_norm_act': [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build (or load) that made _lib
build_log = ''           # nvcc's output, -Xptxas -v register/smem report


def _nvcc() -> str:
    candidates = [os.path.join(os.environ[v], 'bin', 'nvcc')
                  for v in ('CUDA_HOME', 'CUDA_PATH') if os.environ.get(v)]
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'of masklab_tpu_torch are built from source at first '
                       'use')


def _digest() -> str:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update(' '.join(ARCH_FLAGS + COMMON_FLAGS + flags).encode())
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f'$ {" ".join(cmd)}\n{out}')
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return '\n'.join(outs)


def _build(so_path: str) -> str:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for name, flags in SOURCES.items():
            obj = os.path.join(tmp, name.replace('.cu', '.o'))
            objs.append(obj)
            cmds.append([nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *flags, '-c',
                         os.path.join(CSRC_DIR, name), '-o', obj])
        log = _run_all(cmds)
        tmp_so = os.path.join(tmp, 'lib.so')
        log += _run_all([[nvcc, *ARCH_FLAGS, '-shared', '-o', tmp_so, *objs]])
        os.replace(tmp_so, so_path)       # atomic: concurrent builds agree
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has none."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        start = time.perf_counter()
        so_path = os.path.join(BUILD_DIR, f'libmasklab_kernels_{_digest()}.so')
        if not os.path.isfile(so_path):
            build_log = _build(so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mlk_error_string.argtypes = [_I]
        lib.mlk_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - start
        _lib = lib
        return lib


def register_report() -> list:
    """One line per compiled kernel from the last build's ``-Xptxas -v``
    output: entry function and its registers / shared memory / spills."""
    lines, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ('Used' in line or 'spill' in line):
            lines.append(f'{name}: {line.split(":", 1)[-1].strip()}')
    return lines


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        name = _lib.mlk_error_string(status).decode()
        raise RuntimeError(f'{kernel}: CUDA error {status} ({name})')
