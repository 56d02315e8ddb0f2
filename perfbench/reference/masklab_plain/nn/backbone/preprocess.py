"""Backbone input preprocessing.

Port of ``masklab_tpu/nn/backbone/preprocess.py``: optional RGB->BGR swap,
ImageNet mean shift and one of four normalize modes, per backbone.
"""
from __future__ import annotations

import torch

_MEAN_RGB = (123.68, 116.779, 103.939)
_STD_RGB = (0.225, 0.224, 0.229)

# backbone_type -> (rgb, mean_shift, normalize)
PREPROCESS_COMBOS = {
    'resnet50': (False, True, 0),
    'seresnet34': (True, False, 0),
    'efficientnetb2': (True, True, 3),
    'efficientnetb3': (True, True, 3),
    'efficientnetb4': (True, True, 3),
}


def preprocess_input(images: torch.Tensor, rgb: bool = True,
                     mean_shift: bool = False,
                     normalize: int = 0) -> torch.Tensor:
    """Apply a preprocessing combo to RGB [0, 255] images [..., H, W, 3]."""
    x = images.float()
    mean, std = _MEAN_RGB, _STD_RGB
    if not rgb:
        x = x.flip(-1)
        mean, std = mean[::-1], std[::-1]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    if mean_shift:
        x = x - mean
    if normalize == 1:
        return x / 255.0
    if normalize == 2:
        return x / 127.5 if mean_shift else x / 127.5 - 1.0
    if normalize == 3:
        return (x / 255.0) / std
    return x


def preprocess_for(backbone_type: str, images: torch.Tensor) -> torch.Tensor:
    rgb, mean_shift, normalize = PREPROCESS_COMBOS[backbone_type.lower()]
    return preprocess_input(images, rgb=rgb, mean_shift=mean_shift,
                            normalize=normalize)
