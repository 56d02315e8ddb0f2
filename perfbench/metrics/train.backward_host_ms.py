"""Host ms a step in the step's backward (train.steps.gradients, the stage:backward span)."""
from perfbench.harness import readings

read = readings.counter_mean_ms("backward_s")
