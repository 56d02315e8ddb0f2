"""Device idle while the loop thread's innermost span is stage:pad or stage:upload, % of the traced window."""
from perfbench.harness import spans

read = spans.idle_in('pad_upload')
