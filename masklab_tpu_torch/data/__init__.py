"""Host-side data pipeline: ETL, dataset, generator, synthetic fixtures
(the port's own copy of ``masklab_tpu/data``, numpy / cv2, no pandas)."""
from .dataset import MaskLabDataset, read_image, read_mask
from .generator import (MaskLabGenerator, MultiprocessLoader,
                        PrefetchIterator, pad_boxes_to)
from .imglab import dataframe_to_imglabformat, imglabformat_to_dataframe
from .process import (get_image_cases, load_label_dataframes_from_imglab_files,
                      load_split_cases, process_dataset, process_instance,
                      process_semantic)
from .synthetic import make_random_batch, make_synthetic_dataset

__all__ = [
    'MaskLabDataset', 'MaskLabGenerator', 'MultiprocessLoader',
    'PrefetchIterator', 'pad_boxes_to',
    'read_image', 'read_mask', 'imglabformat_to_dataframe',
    'dataframe_to_imglabformat', 'process_dataset', 'process_semantic',
    'process_instance', 'load_label_dataframes_from_imglab_files',
    'load_split_cases', 'get_image_cases', 'make_synthetic_dataset',
    'make_random_batch',
]
