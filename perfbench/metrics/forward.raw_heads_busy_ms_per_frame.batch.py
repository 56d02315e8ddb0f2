"""Device ms a frame under the program's ``stage:raw_heads`` span: the
backbone, the FPN, the class and box heads and the semantic head."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('stage:raw_heads')
