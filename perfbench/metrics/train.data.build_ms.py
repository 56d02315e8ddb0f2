"""Wall ms the prefetch thread spends on a batch: its data:batch span, the queue put included."""
from perfbench.harness import spans

read = spans.span_mean_ms('data:batch')
