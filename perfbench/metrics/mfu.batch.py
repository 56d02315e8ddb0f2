"""The traced window's forward operations over the H100's bf16 peak."""
from perfbench.harness.readings import mfu as read  # noqa: F401
