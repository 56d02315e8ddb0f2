"""The kernels' shares of their rooflines together, time-weighted."""
from perfbench.harness import readings

read = readings.roofline("kernels")
