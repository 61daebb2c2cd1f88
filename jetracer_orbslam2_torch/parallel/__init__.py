"""Measurement harnesses (counterpart of `jetracer_orbslam2_tpu/parallel/`); one
device for now."""
