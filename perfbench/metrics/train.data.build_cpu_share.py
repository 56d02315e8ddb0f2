"""The prefetch thread's CPU time over its wall time building a batch (data:batch less data:queue_put), %."""
from perfbench.harness import spans

read = spans.build_cpu_share
