"""The counter data.queue_empty (the loop found the prefetch queue empty) over the window's steps, %."""
from perfbench.harness import spans

read = spans.queue_empty_share
