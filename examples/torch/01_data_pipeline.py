"""Walkthrough 1 (PyTorch port): the data pipeline.

The port's counterpart of ``examples/01_data_pipeline.py``: builds a
synthetic imglab-format dataset, runs the ETL, inspects one sample and one
generator batch. Host-side only (numpy / cv2).

    python examples/torch/01_data_pipeline.py [data_dir]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from masklab_tpu_torch.data import (MaskLabDataset, MaskLabGenerator,
                                    make_synthetic_dataset, process_dataset)


def main(data_dir=None, num_images=8):
    """Returns {'images': n, 'sample': {key: shape}, 'batch': {key:
    (shape, dtype)}}."""
    data_dir = data_dir or os.path.join(tempfile.gettempdir(),
                                        'masklab_torch_demo')
    if not os.path.isdir(os.path.join(data_dir, 'images')):
        print('creating synthetic dataset...')
        make_synthetic_dataset(data_dir, num_images=num_images)
    process_dataset(data_dir, num_workers=1)

    ds = MaskLabDataset(data_dir=data_dir, min_area=100.0)
    print(f'{len(ds)} images')
    sample = {k: np.asarray(v).shape for k, v in ds[0].items()}
    for key, shape in sample.items():
        print(f'  {key}: {shape}')

    gen = MaskLabGenerator(ds.get_config(), batch_size=2, shuffle=False)
    batch = {k: (v.shape, str(v.dtype)) for k, v in gen[0].items()}
    print('generator batch:')
    for key, (shape, dtype) in batch.items():
        print(f'  {key}: {shape} {dtype}')
    return dict(images=len(ds), sample=sample, batch=batch)


if __name__ == '__main__':
    main(*sys.argv[1:])
