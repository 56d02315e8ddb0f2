"""Peak allocated device memory up to the window's end."""
from perfbench.harness.readings import peak_gib as read  # noqa: F401
