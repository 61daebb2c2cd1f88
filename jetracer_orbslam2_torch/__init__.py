"""jetracer_orbslam2_torch — PyTorch/CUDA port of the visual-SLAM framework.

The counterpart of `jetracer_orbslam2_tpu`, module for module, for one NVIDIA
Hopper card.  Plain tensor code is PyTorch; the four kernels (fused FAST +
3x3 NMS in `ops/fused_fast.py`, the patch gather in `ops/fused_patches.py`,
the two bundle-adjustment kernels in `ops/fused_ba.py`, their CUDA sources
under `csrc/`) are written by hand for sm_90a.

Layout mirrors the JAX package so a reader finds the counterpart of a module
by its path:

- `ops/`     preprocess, FAST, NMS, patches, ORB, matching, geometry, align
- `models/`  frontend, stereo, tracking, odometry, imu, slam (the host
             scheduler), slam_scan (whole sequences), backend/ (map, BA,
             pose graph, loop)
- `io/`      synthetic RGB-D and stereo sequences (arc and laps) with exact
             ground truth; TUM RGB-D, EuRoC and KITTI loaders; the native
             PNG decoder (C++ from `native/`, built at first use)
- `utils/`   device resolution, float32 precision settings
- `run.py`   CLI entry (`python -m jetracer_orbslam2_torch.run`, on
             `--synthetic N` frames or a `--dataset DIR`)

Every entry point runs on `cuda:0` unless the caller passes `device="cpu"`;
nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"
