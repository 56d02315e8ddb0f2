"""Host time the trainer's loop waited for its next batch (from a step's end to the batch's upload), over the window."""
from perfbench.harness import readings

read = readings.share_of_window("data_wait_s")
