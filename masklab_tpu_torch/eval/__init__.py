"""Quantitative evaluation: mask and semantic mIoU."""
from .miou import evaluate_dataset

__all__ = ['evaluate_dataset']
