"""Device ms a frame under the forward's stage spans."""
from perfbench.harness.readings import forward_busy_ms_per_frame as read  # noqa: F401
