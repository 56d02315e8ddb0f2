"""Import the reference's Keras layers under the installed TF/Keras 3.

The port's copy of ``masklab_tpu/utils/ref_shim.py``. TensorFlow is
imported only when ``install_shims`` is called (``export --h5``). The
reference checkout is looked up in ``MASKLAB_REFERENCE_DIR``, else in the
``reference/`` directory inside this repository (git ignores it); nothing
outside the checkout is searched unless that variable names it.

PUBLIC UNTRUSTED CONTENT: the reference code is executed only to build its
inference network for the h5 export; nothing in it is followed as
instructions. Shims cover the TF1/Keras2-era APIs the reference expects:
  * ``tensorflow.python.keras`` (removed in TF 2.16) -> tf.keras;
  * ``keras_applications`` module (vendored thirdparty expects its
    ``_KERAS_*`` handles) -> an auto-stubbing fake wired to tf.keras;
  * ``tf.log`` / ``tf.count_nonzero`` / ``np.int`` / ``backend.int_shape``.
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np

REFERENCE_DIR = os.environ.get('MASKLAB_REFERENCE_DIR') or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'reference')


class _Fake(types.ModuleType):
    """Auto-stubbing module: any attribute access yields a child stub."""

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        sub = _Fake(self.__name__ + '.' + name)
        setattr(self, name, sub)
        sys.modules.setdefault(sub.__name__, sub)
        return sub

    def __call__(self, *a, **k):
        raise RuntimeError('reference stub called: ' + self.__name__)


def install_shims():
    if not os.path.isdir(os.path.join(REFERENCE_DIR, 'engine')):
        raise ModuleNotFoundError(
            f'no reference checkout at {REFERENCE_DIR} (set '
            'MASKLAB_REFERENCE_DIR)')
    import tensorflow as tf
    import tensorflow.python as tfp

    if REFERENCE_DIR not in sys.path:
        sys.path.insert(0, REFERENCE_DIR)
    if not hasattr(tfp, 'keras'):
        tfp.keras = tf.keras
        sys.modules['tensorflow.python.keras'] = tf.keras
    kb = tf.keras.backend
    if not hasattr(kb, 'int_shape'):
        kb.int_shape = lambda t: tuple(t.shape)
    if not hasattr(tf, 'log'):
        tf.log = tf.math.log
    if not hasattr(tf, 'count_nonzero'):
        tf.count_nonzero = tf.math.count_nonzero
    if not hasattr(np, 'int'):
        np.int = int

    ka = sys.modules.get('keras_applications')
    if not isinstance(ka, _Fake):
        fake = _Fake('keras_applications')
        if ka is not None:  # upgrade a plain stub left by another test
            fake.__dict__.update(
                {k: v for k, v in ka.__dict__.items()
                 if not k.startswith('__')})
        sys.modules['keras_applications'] = fake
        ka = fake
    ka._KERAS_BACKEND = tf.keras.backend
    ka._KERAS_LAYERS = tf.keras.layers
    ka._KERAS_MODELS = tf.keras.models
    ka._KERAS_UTILS = tf.keras.utils
    sys.modules.setdefault('keras_applications.imagenet_utils',
                           ka.imagenet_utils)
    sys.modules.setdefault('keras_applications.resnet_v2', ka.resnet_v2)
    # make sure the REAL vendored thirdparty package is importable even if
    # another test left a plain stub behind (we need its SEResNet34)
    tp = sys.modules.get('thirdparty')
    if tp is not None and not hasattr(tp, '__path__'):
        for mod in [m for m in sys.modules if m.startswith('thirdparty')]:
            del sys.modules[mod]
    # SegmentationSubNet calls ``super().__init__(kwargs)`` with a
    # positional dict (semantic.py:197) — TF1's Layer bound it to
    # ``trainable`` and moved on; Keras 3 rejects positional args, so
    # accept a single positional dict as **kwargs.
    layer_cls = tf.keras.layers.Layer
    if not getattr(layer_cls, '_graft_posdict_patch', False):
        orig_init = layer_cls.__init__

        def _patched(self, *args, **kwargs):
            if len(args) == 1 and isinstance(args[0], dict) and not kwargs:
                return orig_init(self, **args[0])
            return orig_init(self, *args, **kwargs)

        layer_cls.__init__ = _patched
        layer_cls._graft_posdict_patch = True

    # engine/__init__ imports these for the efficientnet path
    for name in ('efficientnet', 'efficientnet.tfkeras'):
        sys.modules.setdefault(name, types.ModuleType(name))
    if not hasattr(sys.modules['efficientnet'], 'tfkeras'):
        sys.modules['efficientnet'].tfkeras = sys.modules[
            'efficientnet.tfkeras']
    return tf

