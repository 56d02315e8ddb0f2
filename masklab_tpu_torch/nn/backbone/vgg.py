"""VGG16 backbone.

Port of ``masklab_tpu/nn/backbone/vgg.py``: five blocks of biased 3x3
convs with relu, each followed by a 2x2 stride-2 max pool. C1-C4 are the
last conv activations of blocks 2-5 (strides 2 to 16), C5 the last pool
(stride 32).
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import max_pool, same_conv

# (convs, channels) per block
_CFG = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
# block (1-based) whose last conv activation is the endpoint
_TAPS = {2: 'C1', 3: 'C2', 4: 'C3', 5: 'C4'}
CHANNELS = {'C1': 128, 'C2': 256, 'C3': 512, 'C4': 512, 'C5': 512}


class VGG16(nn.Module):
    """Returns a dict of endpoints {'C1': ..., 'C5': ...} (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = 3
        for bi, (convs, out) in enumerate(_CFG, start=1):
            for ci in range(convs):
                self.add_module(f'block{bi}_conv{ci + 1}',
                                same_conv(ch, out, 3, dtype=dtype))
                ch = out

    def forward(self, x, generator=None):
        endpoints = {}
        x = x.to(self.dtype)
        for bi, (convs, _) in enumerate(_CFG, start=1):
            for ci in range(convs):
                x = torch.relu(getattr(self, f'block{bi}_conv{ci + 1}')(x))
            if bi in _TAPS:
                endpoints[_TAPS[bi]] = x
            x = max_pool(x, 2, 2, site=(self, bi))
        endpoints['C5'] = x
        return endpoints
