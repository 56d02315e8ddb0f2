"""Device ms a frame under the program's ``stage:nms`` span: box decoding
and the two-stage class-aware NMS (K2's candidate pool, K3)."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('stage:nms')
