"""The band_groupnorm_backward share of the roofline over the traced window's launches, time-weighted."""
from perfbench.harness import readings

read = readings.roofline("band_groupnorm_backward")
