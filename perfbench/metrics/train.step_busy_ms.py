"""Device busy ms a train step over the traced window."""
from perfbench.harness import readings

read = readings.busy_ms_per("steps")
