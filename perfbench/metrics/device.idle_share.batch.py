"""Share of the traced window with no device operation."""
from perfbench.harness.readings import idle_share as read  # noqa: F401
