"""Device ms a frame under the program's ``mbconv:se`` span, in every
MBConv block of an EfficientNet body: squeeze-excite's spatial mean, its
two 1x1 convs, swish, sigmoid and the gate's multiply."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('mbconv:se')
