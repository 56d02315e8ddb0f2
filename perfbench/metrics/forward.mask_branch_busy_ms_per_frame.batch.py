"""Device ms a frame under the program's ``stage:mask_branch`` span: the
routing of boxes to levels, the RoI crops and the mask heads (K1)."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('stage:mask_branch')
