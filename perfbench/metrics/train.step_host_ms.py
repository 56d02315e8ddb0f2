"""Host ms a step in its step span, less its stage:data_wait."""
from perfbench.harness import spans

read = spans.step_host_ms
