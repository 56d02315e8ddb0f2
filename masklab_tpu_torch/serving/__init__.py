"""Serving runtime: predictor, postprocess, drawing, analytics, servers."""
from .grpc_server import MaskLabGrpcServer, send_image_to_grpc
from .postprocess import crop_and_pad_masks, smooth_semantics, upsample_output
from .predictor import MaskLabPredictor, summary_to_records
from .server import MaskLabServer, process_folder, send_image_to_server
from .summary import (calculate_instance_size, crack_to_instance,
                      include_my_road, summary_output)
from .visualize import draw_boxes, draw_instance, draw_segmentation

__all__ = [
    'MaskLabPredictor', 'MaskLabServer', 'MaskLabGrpcServer',
    'send_image_to_grpc', 'summary_to_records',
    'send_image_to_server', 'process_folder', 'crop_and_pad_masks',
    'smooth_semantics', 'upsample_output', 'summary_output',
    'crack_to_instance', 'include_my_road', 'calculate_instance_size',
    'draw_boxes', 'draw_instance', 'draw_segmentation',
]
