"""Images trained over the traced window: the cell's rate, which spreads
from run to run with the host, so that it is read here and bounded by no
end-to-end metric (PERF.md section 2)."""
from perfbench.harness import readings

read = readings.per_second_of_window("traced_frames")
