"""The band_groupnorm share of the roofline over the traced window's launches, time-weighted."""
from perfbench.harness import readings

read = readings.roofline("band_groupnorm")
