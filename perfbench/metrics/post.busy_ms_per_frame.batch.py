"""Device ms a frame under stage:postprocess."""
from perfbench.harness.readings import post_busy_ms_per_frame as read  # noqa: F401
