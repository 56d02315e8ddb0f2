"""Device ms a frame under the program's ``mbconv:project`` span, in every
MBConv block of an EfficientNet body: the 1x1 projection, its BatchNorm,
drop-connect and the residual add."""
from perfbench.harness.device_spans import busy_ms_per_frame

read = busy_ms_per_frame('mbconv:project')
