"""Device idle while the loop thread's innermost span is stage:data_wait, % of the traced window (the program's spans; the recorder on)."""
from perfbench.harness import spans

read = spans.idle_in('data_wait')
