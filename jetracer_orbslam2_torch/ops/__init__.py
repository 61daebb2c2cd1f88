"""Dense image and geometry ops of the port (counterparts of
`jetracer_orbslam2_tpu/ops/`): plain PyTorch functions on tensors, plus the
hand-written FAST+NMS kernel's wrapper in `fused_fast.py`."""
