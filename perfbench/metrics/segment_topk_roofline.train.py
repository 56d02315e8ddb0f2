"""The segment_topk share of the roofline over the traced window's launches, time-weighted."""
from perfbench.harness import readings

read = readings.roofline("segment_topk")
