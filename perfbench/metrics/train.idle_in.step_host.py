"""Device idle while the loop thread's innermost span is stage:forward, losses, backward or optimizer, % of the traced window."""
from perfbench.harness import spans

read = spans.idle_in('step_host')
