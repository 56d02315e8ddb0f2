"""A frozen copy of the program's plain paths, standing alone and cut to
what the benchmark's configurations run: the model (the resnet50 and
seresnet34 bodies, FPN, plain and squeeze-excite heads, two-stage NMS,
mask branch, semantic head), its losses and optimizer, and the summarize
postprocess, with every hand-written kernel replaced by its plain PyTorch
version. It imports nothing of the program. Run it in float32 with TF32
off (``perfbench.reference.pipeline``)."""
