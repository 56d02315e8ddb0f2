"""Device ms a frame under the program's ``mbconv:expand`` span, in every
MBConv block of an EfficientNet body: the 1x1 expansion, its BatchNorm
and swish (absent where the expand ratio is 1)."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('mbconv:expand')
