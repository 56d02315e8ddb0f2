"""Wall ms of a batch's data:read span: the dataset's slice, its decodes and re-rasterization."""
from perfbench.harness import spans

read = spans.span_mean_ms('data:read')
