"""Device ms a frame under the program's ``mbconv:depthwise`` span, in
every MBConv block of an EfficientNet body: the stride-2 padding, the
depthwise conv, its BatchNorm and swish."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('mbconv:depthwise')
