#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # no arguments, one GPU
    python3 chip_smoke.py --kernels  # phases 1-3, 6, 7, 11, 16 only

Drives `jetracer_orbslam2_torch`'s paths through the functions a user calls:
RGB-D odometry on a synthetic 640x480 sequence at the CLI's defaults (4
pyramid levels, 1024 keypoints, 256 RANSAC hypotheses), standalone bundle
adjustment at 8 poses x 4,096 landmarks, windowed BA over a keyframe map at
its full capacity (256 keyframe slots, 16,384 landmarks, 65,536
observations), the pose graph, landmark-sharded BA over a `torch.distributed`
group (one rank with NCCL, and two ranks on the one card with gloo) and the
CLI's `--mesh 1`, and the full SLAM system (`slam_scan`, `Slam`, the CLI's
default mode) with loop closure: a 126-frame lap at 240x180 and
1,200 frames of 640x480 over three laps; the stereo SLAM system over 120
stereo pairs of 640x480 (an arc and a lap); the CLI on the committed TUM,
EuRoC and KITTI fixtures; and the CLI's host loop behind the runtime
(frame pipeline, watchdog, WebSocket telemetry, checkpoint and resume) on a
640x480 TUM-layout sequence.  The odometry step and the tracking half of a
SLAM frame are captured once into a CUDA graph and replayed once a frame on
every path; phase 22 holds them against their eager steps.  It builds the
hand-written CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version, shows that each path launched its
kernels (a replay launches each of its graph's kernel nodes once), and times
them.

Phases (any failure ends the run with a non-zero exit; there is no CPU path):
   1 device       a CUDA device must be present; prints the card's name and
                  power limit as nvidia-smi gives them
   2 build        nvcc compiles csrc/fast_nms.cu, csrc/ba_fused.cu,
                  csrc/patch_gather.cu, csrc/rigid_fit.cu,
                  csrc/pose_polish.cu and csrc/ransac_hyp.cu side by side;
                  prints seconds and ptxas' notes
   3 K1, K4 check fast_nms kernel vs plain version, torch.equal: the one-level
                  call at every shape, the batched call (every level of a
                  pyramid, one or two thresholds, one launch) on frame 0's
                  levels, odd shapes, 1 and 8 levels, an unaligned level;
                  K4's levels entry (extract_patches_fused) vs
                  extract_patches, torch.equal, on the pyramids
                  of rendered frames at three sizes, on levels smaller than
                  the patch, at K = 1 and 0, on 1 and 8 levels; its canvas
                  entry (patch_gather) vs its plain version on adversarial
                  window origins; two launches bit-identical
   4 semantics    tie orders and CPU/GPU agreement of the front-end
   5 main path    whole-sequence odometry: ATE, tracked fraction, kernel
                  launches (K1 and K4 once a frame, K5, K6 and K7 once a
                  stepped frame: the refit pair in one launch, the polish in
                  one launch, RANSAC's hypotheses in one launch; no canvas
                  packed);
                  --chunked 32 on the same frames gives the same poses; a
                  second, warm run is timed
   6 K1 time      the empty-kernel launch floor; device time of the one
                  launch a frame at one and two thresholds, and of the old
                  schedule (one launch per level and threshold) in the same
                  run; the plain version and the bound; the one-level launch
                  per level shape; a stereo frame's two 4-level pyramids by
                  one launch each against one launch of all 8 levels
                  (torch.equal outputs), in the same run
   7 K2/K3 check  fused_normal_schur and fused_backsub vs their plain
                  versions at every listed (P, L), against a float64 truth;
                  bit-identical between two launches and between two replays
                  of a captured CUDA graph
   8 BA path      bundle_adjust, 8 x 4,096, 10 iterations through the
                  kernels: trace, gauge, launches, agreement with the dense
                  route; ms per LM iteration of both routes
   9 local BA     eight keyframes of the rendered sequence inserted into a
                  full-size map, then local_ba by both routes
  10 pose graph   a drifted ring closes; a second run gives the same poses
  11 K2/K3 time   device time per launch beside the counted bound, the
                  floor and the plain version's time
  12 SLAM lap     126 frames of 240x180 around one lap with 2 %.z^2 depth
                  noise: slam_scan twice (bit-identical) and Slam on the same
                  frames must agree; over three draws of the noise every lap
                  must track, close a loop and leave at most half of the
                  revisit's gap that a run with no closure leaves, and the
                  median ATE must stay under 58 cm
  13 SLAM path    slam_scan over 1,200 frames of 640x480, three laps, map of
                  128 keyframe slots / 16,384 landmarks / 65,536 observations:
                  tracked fraction, loops, ATE, every kernel's launch count
                  (K6 twice a stepped frame: the tracker's and the map's
                  polish; K7 at least once: the tracker's RANSAC, and each
                  loop verification and relocalization; no canvas packed);
                  frames/s of the run
  14 lifecycle    three laps at 240x180 with 32 keyframe slots: keyframes are
                  culled and their slots recycled, tracking holds to the end
  15 CLI          run.main at its default mode (slam), whole and --chunked 8
  16 K4 time      device time of the levels kernel (two readings around
                  the others), the canvas kernel, PR 4's whole route, the plain version,
                  the one indexing call that computes the same, a copy of
                  the output's bytes, the floor and the bound, in one run
  17 stereo check frontend_stereo on a 640x480 pair, card vs CPU (keypoints
                  torch.equal, descriptors, disparity-derived points); one
                  call under set_sync_debug_mode("error"); launches a call
                  (one K1 launch for both pyramids, torch.equal to one launch
                  an image; at 5 levels, launches of 8 and 2 levels)
  18 stereo path  slam_scan over 120 stereo pairs of 640x480, an arc and a
                  lap of 105 (bench.py's stereo rows): ATE, tracked fraction,
                  loops and keyframes as the JAX package reaches them, every
                  kernel's launch count; frames/s
  19 datasets     run.main --dataset on every fixture (TUM registered and
                  not, EuRoC rectified and distorted, KITTI; whole and
                  --chunked 4) on the card with the CPU tests' bars; which
                  PNG decoder served; align_depth_to_color card vs CPU
  20 runtime      the CLI's --mode slam host loop (640x480, 4 levels,
                  K=1024) on a 120-frame TUM-layout sequence written here:
                  A the loop without its runtime (this script drives Slam),
                  B run.main --dataset (FramePipeline + Watchdog), C B +
                  --telemetry with a client + --checkpoint, D --resume from
                  C's map (30 frames), then B and A again; A, B, C agree to
                  the pose (torch.equal), ATE < 10 cm, K1/K4 once a frame,
                  K2 = K3 = 10 x keyframe updates, K5 >= 2 a tracked frame,
                  K6 = 2 and K7 >= 1 a stepped frame, no watchdog stall,
                  every frame pinned, host waits a frame
                  equal in A and B and at
                  most one more a frame in C's publish, every telemetry
                  document the viewer's fields at 640x480, the checkpoint's
                  keyframes; overlay_keypoints card vs CPU; ms a frame,
                  decode, JPEG time and bytes a frame recorded
  21 sharded BA   (a) sharded_bundle_adjust 8 x 4,096 on a one-rank NCCL
                  group: torch.equal to bundle_adjust, K2 = K3 = 10, no host
                  wait in the call (sync debug "error"); ms per LM iteration
                  at 10 and 50 iterations beside time_ba, in turns;
                  measure_scaling (one row a card); (b) sharded_local_ba on
                  phase 9's full-capacity map: torch.equal to local_ba,
                  nothing dropped; (c) run.main --synthetic 120 --mode slam
                  --mesh 1, whole and --chunked 8, against the meshless runs:
                  exit 0 on cuda:0, keyframes, loops, relocs, poses and
                  tracked flags equal, ATE < 10 cm, tracked >= 0.95, K1 = K4
                  = frames, K2 = K3 = 10 x keyframe updates, K5 >= 2 a
                  tracked frame, K6 = 2 and K7 >= 1 a stepped frame,
                  mesh_devices 1,
                  ba_edges_dropped 0; (d)
                  the distributed worker twice on
                  this card over gloo (2,048 landmarks a rank): ranks
                  bit-identical, poses 5e-3 and points 2e-2 of (a), cost
                  below 0.2 x initial, K2 = K3 = 10 a rank; ms per iteration
  22 graphs       (a) K5's two entries vs their plain versions, the SVD
                  route: rigid_fit's rotation entries and translations (of
                  the points' scale) within 1e-5 at B 1 and 8, N 1,024, 0/1
                  weights, no weights, all weights 0 (exactly the
                  identity), coplanar points; a proper rotation on
                  collinear points; rigid_refit's T within 1e-5 and its
                  weights and count equal (but for points within 1e-6 of
                  the gate, counted) at B 1 and 8, a gate a point and one
                  for all; relaunch and two graph replays torch.equal; the
                  same bars above the shared-memory path (N 6,145 at B 1,
                  8,192 and 16,384 at B 1 and 8, the streamed path) with
                  their times and bounds; run.main --max-keypoints 8192 in
                  odometry and slam mode on 24 frames (K7's streamed path
                  too: K7 once a stepped frame); the times of both
                  entries, of the two-call route (one graph), of the plain
                  routes, and the bounds; the split: the reduction alone,
                  the factorisation alone, both; (b)
                  the eager odometry_step over
                  the 120 frames under set_sync_debug_mode("error"); (c)
                  odometry_scan's graph against the eager step loop: poses
                  and flags torch.equal, ATE < 10 cm, tracked >= 0.95, one
                  capture, frames - 2 replays after one eager warm-up frame,
                  K1 = K4 = frames and K5 = K6 = K7 = stepped frames by
                  nodes x replays; (d) slam_scan and Slam (the tracking graph)
                  against their eager tracking steps: poses, flags,
                  keyframes, loops equal, one host wait a plain frame, the
                  same graph counts; the same equalities on the arc's first
                  60 frames with frames 30-33 blank, where both relocalize
                  (>= 1 reloc each); (e) ms a frame graphed and eager in
                  turns, and each one's device-busy share and device kernels
                  and copies a frame over frames 40-79
  23 K6           pose_polish vs its plain version (the Gauss-Newton loop
                  of tracking.refine_pose_reprojection before K6): rotation
                  entries and translations (of the points' scale) within
                  1e-5 at B 1 and 8, K 1,024; K 8,192 (8 blocks); all
                  weights 0 (exactly T0); no depth rows; 20 % outliers; the
                  problems of the first 40 frames of the odometry run as one
                  batch; the first case and that batch at 1 and 2 steps;
                  K 128, 256 and 512 (the wrapper's 1, 2 and 4 blocks);
                  steps with H not positive definite counted; relaunch and two
                  graph replays torch.equal; the time a launch, the plain
                  version's, the floor and the bound; the split by 0 / 1 / 5
                  steps; through a harness that includes the source, room
                  for 8 points a thread against the points read from memory
                  each step and against room for one (the same bits, in
                  turns), each cluster size forced (within 1e-5) and timed;
                  the graphed odometry frame's device kernels and copies and
                  busy ms beside those with the plain polish, in turns
  24 K7           ransac_select vs its plain version (the hypotheses,
                  scores and first argmax of tracking.ransac_kabsch before
                  K7): the winner and w1 equal (points within 1e-6 of the
                  gate excused and counted; a winner such a point moves must
                  have the plain best score) at B 1, H 256 and 512, K
                  1,024; K 8,192 (the streamed path); all weights 0 (winner
                  0); degenerate draws; collinear points; all scores equal
                  (winner 0); a quadratic gate with a cap; B 8 and the first
                  40 frames' problems of the odometry run as one batch
                  (each row equal to its problem alone); relaunch and two
                  graph replays torch.equal; the time a launch beside the
                  plain version's, the floor and the bound; through a
                  harness that includes the source, every cluster size and
                  the streamed path (the same outputs); the graphed
                  odometry frame's device kernels and copies and busy ms
                  beside those with the plain RANSAC, in turns
Launch counts: a wrapper counts one when it launches its kernel, and a
replay of a captured frame step counts each kernel node of the graph once
(`utils/step_graph.note_launch`), so "once a frame" holds either way.
Kernel times are CUDA events around a replayed CUDA graph of launches.  Then
the paths' reports (the stereo path's and the datasets' on one line, the
runtime's on one, the sharded phase's on one), one JSON line
`{"kernels": [...]}` (K1-K7; launches: the runtime path's, phase 20 run C;
sharded_path_launches the --mesh 1 CLI run's, phase 21c), and as the last
line `{"ok": true, "device": {...}}`.

Imports torch and the port only: no JAX, nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the roofline
# the kernel's bound is computed against.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FAST_THRESHOLD, FAST_ARC, FAST_BORDER = 13.0, 12, 19
SLAM_FAST_MIN_THRESHOLD = 7.0   # the SLAM path's second FAST threshold
N_FRAMES = 120
N_PHASES = 24
GRAPHS_TITLE = (
    "graphs: (a) K5 (rigid_fit, rigid_refit) vs the SVD route, (b) the eager "
    "odometry_step with no host wait, (c) odometry_scan's CUDA graph vs the "
    "eager step "
    "loop, (d) slam_scan's and Slam's tracking graph vs their eager steps, "
    "also through a forced tracking loss, "
    f"(e) ms a frame and device-busy share in turns; {N_FRAMES} frames of "
    "640x480")
PATCH = 37

# SLAM path at full width (the JAX package's long-sequence benchmark): frames,
# frames a lap, depth noise (x z^2), keyframe slots
LONG_FRAMES, LONG_LAP, LONG_NOISE, LONG_KEYFRAMES = 1200, 400, 0.01, 128
LONG_ATE_M = 0.24          # the JAX package's 18.2 cm on this workload + 30 %
# gated lap (an earlier gate of the JAX package at a smaller size)
LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE = (180, 240), 126, 110, 0.02
LAP_NOISE_SEEDS = (0, 1, 2)
# median over the noise draws; the JAX package gives 44.5 cm on the first draw
# when it runs on a CPU (scripts/compare_lap_cpu.py), + 30 %
LAP_ATE_M = 0.58

# stereo path (bench.py's stereo rows, nothing cut): frames, lap length,
# baseline, K1 launches a stereo frame (both pyramids in one launch)
STEREO_FRAMES, STEREO_LAP, STEREO_BASELINE, STEREO_K1_PER_FRAME = 120, 105, 0.11, 1
# bench.py's bars, TPU readings; the JAX package on a CPU gives 2.88 cm (arc)
# and 3.91 cm (lap) on these frames (scripts/compare_stereo_cpu.py), so the
# bars stand.
STEREO_ATE_M = {"arc": 0.15, "lap": 0.21}
# (loops, keyframes) of the JAX package on a CPU on these frames
# (scripts/compare_stereo_cpu.py): the card must reach the same outcome.  No
# loop closes on the lap in either package (bench.py's comment reports one
# on the TPU; ROADMAP.md queue 3).
STEREO_OUTCOME = {"arc": (0, 4), "lap": (0, 12)}

# runtime phase: frames of the 640x480 TUM-layout sequence written on the card,
# and frames of the run resumed from its map
RUNTIME_FRAMES, RUNTIME_RESUME_FRAMES = 120, 30

# BA path: the standalone problem size, and the keyframes of the local-BA map
BA_POSES, BA_LANDMARKS, BA_OBS_PER_LM, BA_ITERS = 8, 4096, 6, 10
KF_EVERY, KF_COUNT = 5, 8


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, reps: int, per_run: int) -> float:
    """Median over `reps` of (CUDA-event time of one `run()`) / per_run, ms."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_run)
    return statistics.median(times)


def time_launches(fn, reps: int, batch: int) -> float:
    """Device ms per call of `fn`: `batch` calls captured into one CUDA graph
    and replayed, so the host's per-call cost drops out and the card's own
    time remains."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, batch)


def fast_nms_work(levels, thresholds, border: int) -> tuple[int, int]:
    """(bytes, f32 operations) the FAST+NMS function needs on THESE levels at
    these thresholds: each level read once and each (level, threshold)
    output written once; per scored pixel 16 subtractions, and per threshold
    32 compares plus 2 more per ring pixel that passes +-t (counted from the
    data), and 9 compares per pixel for the 3x3 max."""
    from jetracer_orbslam2_torch.ops.fast import RING_OFFSETS

    n_bytes = n_ops = 0
    for img in levels:
        h, w = img.shape
        b = border
        n_bytes += 4 * h * w * (1 + len(thresholds))
        scored = max(h - 2 * b, 0) * max(w - 2 * b, 0)
        n_ops += 16 * scored
        for t in thresholds:
            passes = 0
            if scored:
                c = img[b:h - b, b:w - b]
                for dy, dx in RING_OFFSETS:
                    d = img[b + dy:h - b + dy, b + dx:w - b + dx] - c
                    passes += int((d.abs() > t).sum())
            n_ops += 32 * scored + 2 * passes + 9 * h * w
    return n_bytes, n_ops


def phase_kernel_checks(levels) -> tuple[float, bool]:
    """K1 vs its plain version, bit for bit: the one-level call at every
    shape, then the batched call on multi-level lists at one and two
    thresholds.  Returns the max abs error seen and whether every comparison
    was torch.equal."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_fast, preprocess

    dev = levels[0].device

    def integer_image(shape, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(
            rng.integers(0, 256, shape).astype(np.float32)).to(dev)

    cases = [(f"level{i} {tuple(l.shape)}", l.contiguous(), FAST_THRESHOLD,
              FAST_ARC, FAST_BORDER) for i, l in enumerate(levels)]
    for arc in (9, 12, 16):
        cases.append((f"(64,128) arc {arc}", integer_image((64, 128), 0), 13.0, arc, 3))
    cases.append(("(52,70)", integer_image((52, 70), 7), 13.0, 12, 3))
    cases.append(("(41,257)", integer_image((41, 257), 7), 13.0, 12, 3))
    cases.append(("(48,128) border 8 t 40", integer_image((48, 128), 3), 40.0, 12, 8))
    cases.append(("(30,40) smaller than the border", integer_image((30, 40), 5),
                  13.0, 12, 19))
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = torch.rand((203, 331), generator=g, device=dev) * 255.0
    cases.append(("(203,331) non-integer f32", rnd, 7.5, 12, 3))
    cases.append(("(203,331) non-integer f32 arc 9", rnd, 3.25, 9, 5))

    worst, all_equal = 0.0, True

    def compare(name, got, ref):
        nonlocal worst, all_equal
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        equal = torch.equal(got, ref)
        all_equal = all_equal and equal
        if not equal:
            raise SystemExit(f"FAIL: fast_nms kernel disagrees with its plain "
                             f"version at {name}")
        return err, int((ref > 0).sum())

    for name, img, thr, arc, border in cases:
        got = fused_fast.fast_nms_response(img, thr, arc, border)
        ref = fused_fast.fast_nms_response_reference(img, thr, arc, border)
        err, corners = compare(name, got, ref)
        say(f"  kernel vs plain  {name:36s} corners {corners:6d}  "
            f"max_abs_err {err:g}  equal True")

    # the batched call: lists of levels at one and two thresholds
    frame = [l.contiguous() for l in levels]
    odd = [integer_image((64, 128), 0), integer_image((52, 70), 7),
           integer_image((41, 257), 7), integer_image((48, 128), 3),
           integer_image((30, 40), 5), rnd]
    eight = [l.contiguous() for l in preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(integer_image((480, 640), 11)), 8)]
    # a level whose rows are 16-byte multiples but whose start is not
    shifted = torch.empty(1 + 64 * 128, device=dev)[1:].view(64, 128)
    shifted.copy_(integer_image((64, 128), 4))
    batched = [
        ("frame 0, 4 levels", frame, (FAST_THRESHOLD,), FAST_ARC, FAST_BORDER),
        ("frame 0, 4 levels", frame, (FAST_THRESHOLD, 7.0), FAST_ARC, FAST_BORDER),
        ("odd shapes", odd, (13.0,), 12, 3),
        ("odd shapes", odd, (3.25, 7.5), 9, 5),
        ("odd shapes", odd, (13.0, 40.0), 16, 3),
        ("odd shapes, border 19", odd, (13.0, 7.0), 12, 19),
        ("1 level", [rnd], (7.5, 13.0), 12, 3),
        ("8 levels of 480x640", eight, (13.0, 7.0), 12, FAST_BORDER),
        ("8 levels of 480x640", eight, (13.0,), 12, 3),
        ("unaligned level start", [shifted, frame[1]], (13.0, 7.0), 12, 3),
    ]
    for name, lv, thr, arc, border in batched:
        before = fused_fast.fast_nms_pyramid.launches
        got = fused_fast.fast_nms_pyramid(lv, thr, arc, border)
        again = fused_fast.fast_nms_pyramid(lv, thr, arc, border)
        if fused_fast.fast_nms_pyramid.launches != before + 2:
            raise SystemExit("FAIL: fast_nms_pyramid did not launch once a call")
        ref = fused_fast.fast_nms_pyramid_reference(lv, thr, arc, border)
        err = 0.0
        for j in range(len(thr)):
            for i in range(len(lv)):
                label = f"{name} t {thr[j]:g} level {i}"
                err = max(err, compare(label, got[j][i], ref[j][i])[0])
                if not torch.equal(got[j][i], again[j][i]):
                    raise SystemExit(f"FAIL: two launches differ at {label}")
        say(f"  kernel vs plain  pyramid: {name:28s} {len(lv)} levels x "
            f"{len(thr)} thresholds  max_abs_err {err:g}  equal True")

    cpu_level = rnd.cpu()
    for bad in (lambda: fused_fast.fast_nms_response(rnd, 7.5, 12, 2),
                lambda: fused_fast.fast_nms_response(rnd.double(), 7.5, 12, 3),
                lambda: fused_fast.fast_nms_response(rnd.T, 7.5, 12, 3),
                lambda: fused_fast.fast_nms_pyramid([], (7.5,), 12, 3),
                lambda: fused_fast.fast_nms_pyramid([rnd] * 9, (7.5,), 12, 3),
                lambda: fused_fast.fast_nms_pyramid([rnd], (1.0, 2.0, 3.0), 12, 3),
                lambda: fused_fast.fast_nms_pyramid([rnd, cpu_level], (7.5,), 12, 3)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAIL: the wrapper accepted an input the kernel does not take")
    return worst, all_equal


def phase_semantics(dev) -> None:
    """Tie orders the port relies on, and CPU/GPU agreement of the front-end
    on a small 8-bit input (where every level-0/1 pixel is exact in f32)."""
    import torch
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
    from jetracer_orbslam2_torch.utils.ties import first_argmax, first_argmin

    flat = torch.zeros(4096, device=dev)
    order = torch.sort(flat, descending=True, stable=True).indices
    if not torch.equal(order, torch.arange(4096, device=dev)):
        raise SystemExit("FAIL: stable descending sort does not keep index order")
    x = torch.zeros((64, 300), device=dev)
    if int(first_argmax(x, 1)[1].max()) != 0 or int(first_argmin(x, 0)[1].max()) != 0:
        raise SystemExit("FAIL: first_argmax/first_argmin do not take the first index")

    seq = generate_sequence(2, (120, 160), device=dev)
    gray = torch.round(seq.gray)
    cfg = FrontendConfig(height=120, width=160, num_levels=2, max_keypoints=256)
    on_gpu = frontend_gray_depth(gray[1], seq.depth[1], seq.intrinsics, cfg)
    on_cpu = frontend_gray_depth(gray[1], seq.depth[1], seq.intrinsics, cfg,
                                 device="cpu")
    for name in ("xy", "level", "score", "valid", "has_point"):
        if not torch.equal(getattr(on_gpu, name).cpu(), getattr(on_cpu, name)):
            raise SystemExit(f"FAIL: front-end field {name} differs between GPU and CPU")
    valid = on_cpu.valid
    same = (on_gpu.desc.cpu() == on_cpu.desc).all(-1)[valid]
    frac = float(same.float().mean())
    say(f"  front-end GPU vs CPU at 120x160: keypoints identical "
        f"({int(valid.sum())} valid), descriptors identical on {frac:.4f}")
    if frac < 0.99:
        raise SystemExit("FAIL: descriptors differ between GPU and CPU")


def open_source(n_frames: int, dev):
    """Render the sequence on the card through the CLI's own source function;
    returns (parsed args, source tuple, pyramid levels of frame 0)."""
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import preprocess

    argv = ["--synthetic", str(n_frames), "--mode", "odometry", "--json"]
    args = run.build_argparser().parse_args(argv)
    t0 = time.perf_counter()
    source = run._open_source(args, dev)
    torch.cuda.synchronize()
    n, hw = source.n, source.hw
    say(f"  rendered {n} frames of {hw[1]}x{hw[0]} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gray0 = next(iter(source.frames()))[0]
    levels = preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(gray0), args.levels)
    return argv, args, source, levels


@contextlib.contextmanager
def counting_calls():
    """Counts the calls of PR 4's K4 route, `patches.pack_levels` and
    `fused_patches.patch_origins`, while active: the gate that a path
    packs no canvas.  Yields {name: calls}."""
    from jetracer_orbslam2_torch.ops import fused_patches, patches

    counts, saved = {}, []
    for mod, name in ((patches, "pack_levels"), (fused_patches, "patch_origins")):
        fn = getattr(mod, name)
        counts[name] = 0

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_main_path(argv, args, source, dev):
    """Whole-sequence odometry through the CLI's functions; returns the
    report, the kernel's launch count on that run and the tracked poses."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import (
        fused_fast, fused_patches, fused_polish, fused_ransac, fused_rigid)

    n, gt = source.n, source.gt
    fused_fast.fast_nms_pyramid.launches = 0
    fused_patches.extract_patches_fused.launches = 0
    fused_patches.patch_gather.launches = 0
    fused_rigid.rigid_fit.launches = 0
    fused_polish.pose_polish.launches = 0
    fused_ransac.ransac_select.launches = 0
    with counting_calls() as calls:
        report, poses = run._run_odometry(args, source, dev)
    launches = fused_fast.fast_nms_pyramid.launches
    if fused_ransac.ransac_select.launches != n - 1:
        raise SystemExit(f"FAIL: ransac_select launches "
                         f"{fused_ransac.ransac_select.launches} != {n - 1} (one "
                         "RANSAC a stepped frame)")
    if fused_rigid.rigid_fit.launches != n - 1:
        raise SystemExit(f"FAIL: rigid_fit launches {fused_rigid.rigid_fit.launches}"
                         f" != {n - 1} (one RANSAC refit pair a tracked frame)")
    if fused_polish.pose_polish.launches != n - 1:
        raise SystemExit(f"FAIL: pose_polish launches "
                         f"{fused_polish.pose_polish.launches} != {n - 1} (one "
                         "polish a stepped frame, tracked or not)")
    say(f"  K5, K6 and K7: rigid_fit, pose_polish and ransac_select launched "
        f"{n - 1} times each (one a stepped frame)")
    if fused_patches.extract_patches_fused.launches != n:
        raise SystemExit(f"FAIL: extract_patches_fused launches "
                         f"{fused_patches.extract_patches_fused.launches} != {n}")
    if fused_patches.patch_gather.launches or any(calls.values()):
        raise SystemExit(f"FAIL: the odometry path took PR 4's K4 route: "
                         f"patch_gather {fused_patches.patch_gather.launches}, "
                         f"{calls}")
    say(f"  K4: extract_patches_fused launched {n} times (one a frame); "
        f"patch_gather 0, calls {calls}")
    run._accuracy(report, poses, gt, n)
    say("  main path (cold): " + json.dumps(report))
    if not np.isfinite(poses).all() or poses.shape != (n, 4, 4):
        raise SystemExit("FAIL: poses are not finite (N, 4, 4)")
    if launches != n:
        raise SystemExit(f"FAIL: fast_nms_pyramid launches {launches} != {n} "
                         "(one a frame)")
    if not report["ate_rmse_m"] < 0.10:
        raise SystemExit(f"FAIL: ATE RMSE {report['ate_rmse_m']} m >= 0.10 m")
    if not report["tracked_frac"] >= 0.95:
        raise SystemExit(f"FAIL: tracked_frac {report['tracked_frac']} < 0.95")

    # constant-memory streaming on the same frames: the same poses
    chunk_args = run.build_argparser().parse_args(argv + ["--chunked", "32"])
    c_report, c_poses = run._run_odometry(chunk_args, source, dev)
    say("  main path (--chunked 32): " + json.dumps(c_report))
    if not np.array_equal(c_poses, poses):
        raise SystemExit("FAIL: --chunked 32 poses differ from the whole scan "
                         f"(max abs diff {np.abs(c_poses - poses).max():g})")

    # warm run, timed on the device's clock with one final synchronisation
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    w_report, w_poses = run._run_odometry(args, source, dev)
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    if not np.array_equal(w_poses, poses):
        raise SystemExit("FAIL: a second run with the same seed gave other poses")
    report["warm_ms_per_frame"] = ms / n
    report["warm_fps"] = n / (ms / 1e3)
    say(f"  main path (warm): {n} frames in {ms:.1f} ms -> "
        f"{report['warm_fps']:.1f} frames/s ({ms / n:.3f} ms/frame, "
        f"host-clock fps {w_report['fps']})")
    return report, launches, poses


def phase_kernel_times(levels, floor_ms: float) -> dict:
    """K1 on frame 0's pyramid.  Per configuration (odometry: one threshold;
    the SLAM path: two), the one launch a frame and, in the same run and in
    turns (new, old, old, new), the old schedule of one launch per level and
    threshold; the plain version and the bound.  Then per level shape the
    single launch, as before."""
    from jetracer_orbslam2_torch.ops import fused_fast

    frame = [l.contiguous() for l in levels]
    configs = {"odometry": (FAST_THRESHOLD,),
               "slam": (FAST_THRESHOLD, SLAM_FAST_MIN_THRESHOLD)}
    out = {}
    for name, thr in configs.items():
        def new():
            before = fused_fast.fast_nms_pyramid.launches
            ms = time_launches(lambda: fused_fast.fast_nms_pyramid(
                frame, thr, FAST_ARC, FAST_BORDER), reps=20, batch=20)
            assert fused_fast.fast_nms_pyramid.launches > before
            return ms

        def old():
            return time_launches(lambda: [
                fused_fast.fast_nms_response(img, t, FAST_ARC, FAST_BORDER)
                for t in thr for img in frame], reps=20, batch=20)

        new_ms, old_ms = [new()], [old(), old()]
        new_ms.append(new())
        plain_ms = time_launches(
            lambda: fused_fast.fast_nms_pyramid_reference(
                frame, thr, FAST_ARC, FAST_BORDER), reps=10, batch=2)
        n_bytes, n_ops = fast_nms_work(frame, thr, FAST_BORDER)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        row = {
            "thresholds": list(thr), "levels": [list(l.shape) for l in frame],
            "ms": min(new_ms), "readings_ms": new_ms,
            "old_schedule_ms": min(old_ms), "old_schedule_readings_ms": old_ms,
            "old_schedule_launches": len(thr) * len(frame),
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "operations": n_ops, "floor_ms": floor_ms}
        out[name] = row
        say(f"  fast_nms_pyramid, {name} ({len(frame)} levels x {len(thr)} "
            f"thresholds): one launch {new_ms[0] * 1e3:.2f} / {new_ms[1] * 1e3:.2f}"
            f" us a frame; old schedule of {len(thr) * len(frame)} launches "
            f"{old_ms[0] * 1e3:.2f} / {old_ms[1] * 1e3:.2f} us; plain "
            f"{plain_ms:.4f} ms; floor {floor_ms * 1e3:.3f} us; bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {n_bytes} B, "
            f"{n_ops} f32 ops)")

    shapes = []
    for img in frame:
        n_bytes, n_ops = fast_nms_work([img], (FAST_THRESHOLD,), FAST_BORDER)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        ms = time_launches(lambda: fused_fast.fast_nms_response(
            img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=20)
        plain_ms = time_launches(
            lambda: fused_fast.fast_nms_response_reference(
                img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=2)
        row = {"shape": list(img.shape), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": n_bytes, "operations": n_ops}
        shapes.append(row)
        say(f"  fast_nms {tuple(img.shape)}, one level: kernel {ms:.5f} ms on the "
            f"card, plain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}: {n_bytes} B, {n_ops} f32 ops)")
    out["shapes"] = shapes
    return out


# ---------------------------------------------------------------------------
# bundle adjustment: K2 (fused_normal_schur) and K3 (fused_backsub)
# ---------------------------------------------------------------------------

K2_OUTPUTS = ("Hpp", "GhG", "bp", "rhs_gh", "hll_inv", "bl")
PER_LANDMARK = ("hll_inv", "bl", "dxl")     # outputs with the landmark axis last
# Tolerance of a kernel against its plain version, per output: both are
# measured against the plain version evaluated in float64; the kernel's
# error may be at most TOL_FACTOR x the float32 plain version's error plus
# TOL_FLOOR x the output's scale (its largest magnitude; per landmark for the
# per-landmark outputs).  The sums are not bit-exact: the kernel contracts
# a*b+c into FMAs and adds over landmarks in another order than eager PyTorch.
TOL_FACTOR, TOL_FLOOR = 4.0, 1e-5


def ring_problem(n_poses: int, n_landmarks: int, seed: int, dev):
    """Reprojection-only BA problem: landmarks in a box, cameras on an arc,
    every landmark seen from every pose in front of it, perturbed start.
    numpy from `seed`.  Returns (BAProblem without depth, intrinsics)."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.models.backend.ba import BAProblem
    from jetracer_orbslam2_torch.ops import geometry as geo

    rng = np.random.default_rng(seed)
    P, L = n_poses, n_landmarks
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(L, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for i in range(P):
        ang = 0.08 * i
        poses[i, :3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                            [-np.sin(ang), 0, np.cos(ang)]]
        poses[i, :3, 3] = [0.4 * i, 0.05 * i, 0.0]
    kf, lm, uv = [], [], []
    for i in range(P):
        T_cw = np.linalg.inv(poses[i])
        pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        seen = np.nonzero(pc[:, 2] > 0.5)[0]
        px = pc[seen, :2] / pc[seen, 2:3] * 500.0 + np.array([320.0, 240.0])
        kf.append(np.full(len(seen), i))
        lm.append(seen)
        uv.append(px + rng.normal(0, 0.5, px.shape))
    start = poses.copy()
    for i in range(1, P):
        xi = torch.from_numpy(rng.normal(0, 0.03, 6).astype(np.float32))
        start[i] = geo.se3_exp(xi).numpy() @ start[i]
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)  # noqa: E731
    kf, lm, uv = np.concatenate(kf), np.concatenate(lm), np.concatenate(uv)
    prob = BAProblem.without_depth(
        poses=to(start, np.float32), points=to(pts0, np.float32),
        obs_kf=to(kf, np.int32), obs_lm=to(lm, np.int32),
        obs_uv=to(uv, np.float32), obs_valid=to(np.ones(len(kf), bool), bool),
        fixed=to(fixed, bool))
    return prob, to(np.float32([500.0, 500.0, 320.0, 240.0]), np.float32)


def ba_kernel_inputs(prob, intr, lam: float):
    """The fused kernels' arguments for `prob`: (poses_flat, points, obs5,
    lm_free, scalars), as `ba._lm_step_fused` builds them."""
    import torch
    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.models.backend import ba
    from jetracer_orbslam2_torch.ops import geometry as geo

    dev = prob.poses.device
    P, L = prob.poses.shape[0], prob.points.shape[0]
    obs, _ = ba.edges_to_dense(P, L, prob.obs_kf, prob.obs_lm, prob.obs_uv,
                               prob.obs_z, prob.obs_z_valid, prob.obs_valid)
    poses_cw, points = geo.pose_inverse(prob.poses), prob.points
    lm_free = (obs.w.sum(0) >= 2.0).to(torch.float32)[None]
    scalars = torch.tensor(
        [[*intr.tolist(), lam, BAConfig().huber_delta, 0.0, 0.0]],
        dtype=torch.float32, device=dev)
    return (ba.flatten_poses(poses_cw).contiguous(), points.T.contiguous(),
            ba.stack_obs(obs).contiguous(), lm_free.contiguous(), scalars)


def _errors(name, got, plain, truth):
    """(kernel error, plain error, largest |kernel - plain|, scale), the
    errors relative to the output's scale."""
    import torch

    truth = truth.to(torch.float64)
    scale = float(truth.abs().max())
    denom = max(scale, 1e-30)
    if name in PER_LANDMARK:        # scale per landmark, floored
        denom = truth.abs().amax(0, keepdim=True).clamp_min(1e-3 * denom)
    err_k = float(((got.double() - truth).abs() / denom).max())
    err_p = float(((plain.double() - truth).abs() / denom).max())
    return err_k, err_p, float((got - plain).abs().max()), scale


def check_ba_kernels(label: str, inputs, worst: dict) -> None:
    """K2 and K3 on `inputs` against their plain versions; raises SystemExit
    on a disagreement or on two launches that differ."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.models.backend import ba
    from jetracer_orbslam2_torch.ops import fused_ba

    P, L = inputs[0].shape[0], inputs[1].shape[1]
    dev = inputs[0].device
    as64 = lambda xs: [x.double() for x in xs]  # noqa: E731

    got = fused_ba.fused_normal_schur(*inputs)
    again = fused_ba.fused_normal_schur(*inputs)
    plain = fused_ba.fused_normal_schur_reference(*inputs)
    truth = fused_ba.fused_normal_schur_reference(*as64(inputs))
    torch.cuda.synchronize()
    rows = []
    for name, g, a, pl, tr in zip(K2_OUTPUTS, got, again, plain, truth):
        if not torch.equal(g, a):
            raise SystemExit(f"FAIL: two launches of fused_normal_schur differ "
                             f"in {name} at {label}")
        rows.append(("K2", name) + _errors(name, g, pl, tr))

    # a pose step for K3: the solve's own where it exists, else a seeded one
    free = torch.ones(P, dtype=torch.bool, device=dev)
    free[0] = False
    dxp, ok = ba._reduced_solve(got[0], got[1], got[2], got[3],
                                inputs[4][0, 4], free)
    if not (bool(ok) and bool(torch.isfinite(dxp).all())):
        rng = np.random.default_rng(L)
        dxp = torch.from_numpy(
            rng.normal(0, 1e-2, (P, 6)).astype(np.float32)).to(dev)
    dxp = dxp.contiguous()
    k3_in = (*inputs, got[4], got[5], dxp)
    dxl = fused_ba.fused_backsub(*k3_in)
    dxl_again = fused_ba.fused_backsub(*k3_in)
    dxl_plain = fused_ba.fused_backsub_reference(*k3_in)
    dxl_truth = fused_ba.fused_backsub_reference(*as64(k3_in))
    torch.cuda.synchronize()
    if not torch.equal(dxl, dxl_again):
        raise SystemExit(f"FAIL: two launches of fused_backsub differ at {label}")
    rows.append(("K3", "dxl") + _errors("dxl", dxl, dxl_plain, dxl_truth))

    n_free = int(inputs[3].sum())
    say(f"  {label}: P {P}, L {L}, free landmarks {n_free}, "
        f"lambda {float(inputs[4][0, 4]):g}")
    for kern, name, err_k, err_p, diff, scale in rows:
        tol = TOL_FACTOR * err_p + TOL_FLOOR
        good = np.isfinite(err_k) and err_k <= tol
        say(f"    {kern} {name:8s} kernel err {err_k:.3e}  plain err {err_p:.3e}"
            f"  tol {tol:.3e}  |kernel-plain| {diff:.3e} of scale {scale:.3e}"
            f"  {'ok' if good else 'FAIL'}")
        if not good:
            raise SystemExit(f"FAIL: {kern} output {name} disagrees with its "
                             f"plain version at {label}")
        w = worst[kern]
        if scale > 0 and diff / scale >= w["rel"]:
            w.update(rel=diff / scale, abs=diff, scale=scale,
                     where=f"{name} at {label}")


def check_ba_graph_replays(inputs) -> None:
    """fused_normal_schur, then fused_backsub, captured into a CUDA graph:
    two replays (the outputs set to NaN in between) give the eager launch's
    bits, so no state a launch leaves on the card changes the next one."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_ba

    P, L = inputs[0].shape[0], inputs[1].shape[1]
    eager = fused_ba.fused_normal_schur(*inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_ba.fused_normal_schur(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fused_ba.fused_normal_schur(*inputs)
    for replay in (1, 2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for name, o, e in zip(K2_OUTPUTS, outs, eager):
            if not torch.equal(o, e):
                raise SystemExit(f"FAIL: replay {replay} of a captured "
                                 f"fused_normal_schur differs from the eager "
                                 f"launch in {name} at P {P}, L {L}")
    # K3 the same way, on K2's eager outputs and a seeded pose step
    dxp = torch.from_numpy(np.random.default_rng(P + L).normal(
        0, 1e-2, (P, 6)).astype(np.float32)).to(inputs[0].device)
    k3_in = (*inputs, eager[4], eager[5], dxp)
    dxl_eager = fused_ba.fused_backsub(*k3_in)
    with torch.cuda.stream(side):
        fused_ba.fused_backsub(*k3_in)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph3 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph3):
        dxl = fused_ba.fused_backsub(*k3_in)
    for replay in (1, 2):
        dxl.fill_(float("nan"))
        graph3.replay()
        torch.cuda.synchronize()
        if not torch.equal(dxl, dxl_eager):
            raise SystemExit(f"FAIL: replay {replay} of a captured fused_backsub "
                             f"differs from the eager launch at P {P}, L {L}")
    say(f"  graph replays, P {P}, L {L}: two replays of K2 and of K3 equal to "
        "the eager launch")


def phase_ba_kernel_checks(dev) -> dict:
    """K2 and K3 vs their plain versions at every listed shape."""
    import torch
    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
    from jetracer_orbslam2_torch.ops import fused_ba
    from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba

    worst = {k: {"rel": 0.0, "abs": 0.0, "scale": 0.0, "where": ""}
             for k in ("K2", "K3")}
    cases = [
        ("synthetic (8, 4096)", make_synthetic_ba(8, 4096, 6), 1e-3),
        ("synthetic (8, 16384)", make_synthetic_ba(8, 16384, 6), 1e-3),
        ("ring (8, 300), no depth", ring_problem(8, 300, 11, dev), 1e-3),
        ("ring (8, 1100), no depth", ring_problem(8, 1100, 12, dev), 1e3),
        ("synthetic (8, 1)", make_synthetic_ba(8, 1, 6), 1e-3),
        ("ring (6, 200), no depth", ring_problem(6, 200, 13, dev), 1e-3),
        ("synthetic (16, 512)", make_synthetic_ba(16, 512, 6), 1e3),
        ("synthetic (1, 70)", make_synthetic_ba(1, 70, 1), 1e-3),
        # fewer landmark tiles than blocks, and many tiles a block
        ("synthetic (8, 33)", make_synthetic_ba(8, 33, 6), 1e-3),
        ("synthetic (8, 65536)", make_synthetic_ba(8, 65536, 6), 1e-3),
        ("synthetic (16, 16384)", make_synthetic_ba(16, 16384, 6), 1e-3),
        # K3's warps a block: one pose (seven idle warps), two poses a warp,
        # a part-filled last block
        ("synthetic (1, 1)", make_synthetic_ba(1, 1, 1), 1e-3),
        ("synthetic (16, 1)", make_synthetic_ba(16, 1, 6), 1e-3),
        ("synthetic (6, 33)", make_synthetic_ba(6, 33, 6), 1e-3),
        ("ring (16, 300), no depth", ring_problem(16, 300, 14, dev), 1e-3),
        ("synthetic (1, 65536)", make_synthetic_ba(1, 65536, 1), 1e-3),
        ("synthetic (6, 65536)", make_synthetic_ba(6, 65536, 6), 1e-3),
        ("synthetic (16, 65536)", make_synthetic_ba(16, 65536, 6), 1e-3),
    ]
    # the awkward one: landmarks with one or no observation (frozen), slots
    # without depth, a landmark behind every camera; at the start and with
    # poses and points two LM steps on
    prob, intr = make_synthetic_ba(8, 1100, 6, seed=3)
    poses2, points2, _ = bundle_adjust(prob, intr, BAConfig(iters=2), fused=False)
    lm, kf = prob.obs_lm.long(), prob.obs_kf.long()
    first = torch.zeros(1100, dtype=torch.int64, device=dev).scatter_reduce(
        0, lm, kf, "amin", include_self=False)
    once = (lm % 7 == 0) & (kf != first[lm])         # keep one slot of six
    never = lm % 50 == 1
    e = torch.arange(lm.shape[0], device=dev)
    for label, poses, points, lam in (("start", prob.poses, prob.points, 1e-3),
                                      ("2 LM steps on", poses2, points2, 1e3)):
        points = points.clone()
        points[5, 2] = -1.0
        awkward = prob._replace(obs_valid=~(once | never), points=points,
                                obs_z_valid=(e % 3 != 0), poses=poses)
        cases.append((f"synthetic (8, 1100), frozen/no-depth/behind, {label}",
                      (awkward, intr), lam))
    for label, (prob, intr), lam in cases:
        check_ba_kernels(label, ba_kernel_inputs(prob, intr, lam), worst)
    for P, L in ((8, 16384), (8, 33), (16, 4096), (1, 300)):
        check_ba_graph_replays(ba_kernel_inputs(
            *make_synthetic_ba(P, L, min(P, 6)), 1e-3))

    inp = ba_kernel_inputs(*make_synthetic_ba(8, 64, 6), 1e-3)
    too_many = ba_kernel_inputs(*make_synthetic_ba(17, 64, 6), 1e-3)
    for bad in (lambda: fused_ba.fused_normal_schur(*too_many),
                lambda: fused_ba.fused_normal_schur(inp[0].double(), *inp[1:]),
                lambda: fused_ba.fused_normal_schur(inp[0], inp[1].T.contiguous().T,
                                                    *inp[2:]),
                lambda: fused_ba.fused_normal_schur(inp[0], inp[1][:, :63],
                                                    *inp[2:])):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAIL: a BA wrapper accepted an input its kernel does not take")
    try:
        prob17, intr17 = make_synthetic_ba(17, 64, 6)
        bundle_adjust(prob17, intr17, BAConfig(iters=1), fused=True)
    except ValueError:
        pass
    else:
        raise SystemExit("FAIL: bundle_adjust(fused=True) took 17 poses")
    return worst


def _ba_counters():
    from jetracer_orbslam2_torch.ops import fused_ba

    return (fused_ba.fused_normal_schur.launches, fused_ba.fused_backsub.launches)


def _reset_ba_counters() -> None:
    from jetracer_orbslam2_torch.ops import fused_ba

    fused_ba.fused_normal_schur.launches = 0
    fused_ba.fused_backsub.launches = 0


def phase_ba_path(dev) -> dict:
    """`bundle_adjust` at 8 poses x 4,096 landmarks through the kernels."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
    from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba, time_ba

    prob, intr = make_synthetic_ba(BA_POSES, BA_LANDMARKS, BA_OBS_PER_LM)
    cfg = BAConfig(iters=BA_ITERS)
    _reset_ba_counters()
    poses, points, stats = bundle_adjust(prob, intr, cfg)    # fused by default
    launches = _ba_counters()
    trace = stats.cost.cpu().numpy()
    say(f"  fused route: cost trace {np.array2string(trace, precision=2)}")
    if launches != (BA_ITERS, BA_ITERS):
        raise SystemExit(f"FAIL: kernel launches {launches} != ({BA_ITERS}, {BA_ITERS})")
    if not (np.isfinite(trace).all() and bool(torch.isfinite(poses).all())
            and bool(torch.isfinite(points).all())):
        raise SystemExit("FAIL: bundle_adjust returned non-finite values")
    if poses.shape != (BA_POSES, 4, 4) or points.shape != (BA_LANDMARKS, 3):
        raise SystemExit("FAIL: bundle_adjust returned the wrong shapes")
    if (np.diff(trace) > 0).any():
        raise SystemExit("FAIL: the cost trace rises")
    if not trace[-1] < 0.05 * trace[0]:
        raise SystemExit(f"FAIL: final cost {trace[-1]} >= 0.05 x initial {trace[0]}")
    gauge = float((poses[0] - prob.poses[0]).abs().max())
    if gauge > 1e-6:
        raise SystemExit(f"FAIL: the gauge pose moved by {gauge}")

    d_poses, d_points, d_stats = bundle_adjust(prob, intr, cfg, fused=False)
    if _ba_counters() != launches:
        raise SystemExit("FAIL: fused=False launched a kernel")
    d_trace = d_stats.cost.cpu().numpy()
    say(f"  dense route: cost trace {np.array2string(d_trace, precision=2)}")
    dp = float((poses - d_poses).abs().max())
    dx = float((points - d_points).abs().max())
    # the tolerances the JAX package holds its own two routes to
    if not np.allclose(trace, d_trace, rtol=5e-3, atol=0) or dp >= 5e-3 or dx >= 2e-2:
        raise SystemExit(f"FAIL: routes disagree (poses {dp}, points {dx})")
    say(f"  routes agree: poses {dp:.2e}, points {dx:.2e}, gauge moved {gauge:.1e}")

    t_fused = time_ba(prob, intr, cfg, reps=3, fused=True)
    t_dense = time_ba(prob, intr, cfg, reps=3, fused=False)
    t_dense2 = time_ba(prob, intr, cfg, reps=3, fused=False)
    t_fused2 = time_ba(prob, intr, cfg, reps=3, fused=True)
    ms_fused = min(t_fused["ms_per_iter"], t_fused2["ms_per_iter"])
    ms_dense = min(t_dense["ms_per_iter"], t_dense2["ms_per_iter"])
    say(f"  time_ba (warm, host clock, one fetch per run): fused "
        f"{ms_fused:.3f} ms per LM iteration, dense {ms_dense:.3f}; "
        f"cost drop x{t_fused['cost_drop']:.1f}")
    return {
        "problem": [BA_POSES, BA_LANDMARKS, int(prob.obs_kf.shape[0])],
        "iters": BA_ITERS, "launches": list(launches),
        "cost_initial": float(trace[0]), "cost_final": float(trace[-1]),
        "routes_max_pose_diff": dp, "routes_max_point_diff": dx,
        "ms_per_iter_fused": ms_fused, "ms_per_iter_dense": ms_dense,
    }


def phase_local_ba(args, source, poses, dev) -> dict:
    """Eight keyframes of the rendered sequence (every fifth frame, its
    features and its tracked pose) go into a map of full capacity through
    associate_landmarks + insert_keyframe; then local_ba by both routes."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import FrontendConfig, SystemConfig
    from jetracer_orbslam2_torch.models import slam
    from jetracer_orbslam2_torch.models.backend import ba, map as map_mod
    from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
    from jetracer_orbslam2_torch.ops import geometry as geo

    hw, intr = source.hw, source.intr
    fcfg = FrontendConfig(height=hw[0], width=hw[1], num_levels=args.levels,
                          max_keypoints=args.max_keypoints,
                          fast_min_threshold=args.fast_min_threshold)
    cfg = SystemConfig(frontend=fcfg)
    W = cfg.map.window_size
    m = map_mod.init_map(cfg.map, fcfg.max_keypoints)
    frame_list = list(source.frames())
    t0 = time.perf_counter()
    for k in range(KF_COUNT):
        i = k * KF_EVERY
        feats = frontend_gray_depth(frame_list[i][0], frame_list[i][1], intr, fcfg)
        T_wc = torch.from_numpy(poses[i]).to(dev)
        lm_idx, lm_ok = map_mod.associate_landmarks(
            m, feats, T_wc, intr,
            max_hamming=float(cfg.tracking.match_max_hamming),
            window=cfg.tracking.match_window)
        m, _ = map_mod.insert_keyframe(
            m, feats, T_wc, i, feats.has_point & ~lm_ok, lm_idx, lm_ok)
    torch.cuda.synchronize()
    t_insert = time.perf_counter() - t0
    raw = (int(m.num_kf), int(m.num_lm), int(m.num_obs))
    # A landmark seen once is frozen, yet its cross block still enters the
    # Schur complement (as in the JAX package), which makes the reduced
    # system indefinite and every step a rejected one; cull those first.
    m = map_mod.compact_map(m, 2, 0)
    prob, window = slam.window_problem(m, W)
    obs, n_dropped = ba.edges_to_dense(
        W, m.lm_valid.shape[0], prob.obs_kf, prob.obs_lm, prob.obs_uv,
        prob.obs_z, prob.obs_z_valid, prob.obs_valid)
    n_multi = int((obs.w.sum(0) >= 2.0).sum())
    say(f"  map: {raw[0]} keyframes, {raw[1]} landmarks, {raw[2]} observations "
        f"inserted in {t_insert:.2f} s; after culling landmarks seen once: "
        f"{int(m.num_lm)} landmarks, {int(m.num_obs)} observations, "
        f"{n_multi} landmarks with >= 2 observations in the window, "
        f"{int(n_dropped)} colliding edges")
    say(f"  BA problem: P {W}, L {m.lm_valid.shape[0]}, E {m.obs_valid.shape[0]}")
    if n_multi < 300:
        raise SystemExit("FAIL: the map is too thin (fewer than 300 landmarks "
                         "with two observations)")

    def window_cost(state) -> float:
        p, _ = slam.window_problem(state, W)
        r, (_, _, z), _, _, _ = ba._dense_residuals(
            geo.pose_inverse(p.poses), p.points.T, obs, intr)
        return float(ba.robust_cost(r, obs.w * (z > 1e-3), cfg.ba.huber_delta))

    cost0 = window_cost(m)
    _reset_ba_counters()
    m_fused = slam.local_ba(m, intr, W, cfg, fused=True)
    launches = _ba_counters()
    m_dense = slam.local_ba(m, intr, W, cfg, fused=False)
    cost_f, cost_d = window_cost(m_fused), window_cost(m_dense)
    say(f"  window cost {cost0:.2f} -> fused {cost_f:.2f}, dense {cost_d:.2f}")
    if launches != (cfg.ba.iters, cfg.ba.iters) or _ba_counters() != launches:
        raise SystemExit(f"FAIL: local_ba launches {launches}, expected "
                         f"{cfg.ba.iters} of each kernel on the fused route only")
    for name, out, cost in (("fused", m_fused, cost_f), ("dense", m_dense, cost_d)):
        if not all(bool(torch.isfinite(f).all()) for f in out
                   if f.dtype == torch.float32):
            raise SystemExit(f"FAIL: local_ba ({name}) left a non-finite map")
        if not cost < cost0:
            raise SystemExit(f"FAIL: local_ba ({name}) did not lower the window's cost")
        moved0 = float((out.kf_pose[0] - m.kf_pose[0]).abs().max())
        if moved0 > 1e-6:
            raise SystemExit(f"FAIL: local_ba ({name}) moved keyframe 0 by {moved0}")
    dp = float((m_fused.kf_pose - m_dense.kf_pose).abs().max())
    dx = float((m_fused.lm_pos - m_dense.lm_pos).abs().max())
    if dp >= 5e-3 or dx >= 2e-2:
        raise SystemExit(f"FAIL: local_ba routes disagree (poses {dp}, points {dx})")

    def timed(fused) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        slam.local_ba(m, intr, W, cfg, fused=fused)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    runs = {True: [], False: []}
    for fused in (True, False, False, True, True, False):
        runs[fused].append(timed(fused))
    ms_fused, ms_dense = min(runs[True]), min(runs[False])
    chosen = slam.LOCAL_BA_FUSED
    say(f"  local_ba (warm, host clock around one call + sync, best of 3): "
        f"fused {ms_fused:.2f} ms, dense {ms_dense:.2f} ms; routes agree: poses "
        f"{dp:.2e}, points {dx:.2e}; slam.LOCAL_BA_FUSED = {chosen}")
    return {
        "problem": [W, int(m.lm_valid.shape[0]), int(m.obs_valid.shape[0])],
        "keyframes": raw[0], "landmarks": int(m.num_lm),
        "observations": int(m.num_obs), "landmarks_2plus_obs": n_multi,
        "launches": list(launches), "cost_before": cost0,
        "cost_after_fused": cost_f, "cost_after_dense": cost_d,
        "ms_fused": ms_fused, "ms_dense": ms_dense,
        "local_ba_fused_default": chosen,
    }, m


def phase_pose_graph(dev) -> dict:
    """A drifted 12-node ring with one loop edge: the cost drops, the loop
    gap closes, and a second run gives the same poses."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import PoseGraphConfig
    from jetracer_orbslam2_torch.models.backend.pose_graph import (
        PoseGraphProblem, optimize_pose_graph)
    from jetracer_orbslam2_torch.ops import geometry as geo

    P, radius, drift = 12, 2.0, 0.02
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for k in range(P):
        th = 2 * np.pi * k / P
        gt[k, 0, 0] = gt[k, 2, 2] = np.cos(th)
        gt[k, 0, 2], gt[k, 2, 0] = np.sin(th), -np.sin(th)
        gt[k, 0, 3], gt[k, 2, 3] = radius * np.sin(th), radius * (1 - np.cos(th))
    rel = np.stack([np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(P - 1)])
    rng = np.random.default_rng(0)
    est = [gt[0]]
    for k in range(P - 1):
        noise = geo.se3_exp(torch.from_numpy(
            rng.normal(0, drift, 6).astype(np.float32))).numpy()
        est.append(est[-1] @ rel[k] @ noise)
    est = np.stack(est).astype(np.float32)
    loop_T = np.linalg.inv(gt[-1]) @ gt[0]
    chain = np.arange(P - 1)
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)  # noqa: E731
    prob = PoseGraphProblem(
        poses=to(est, np.float32),
        edge_i=to(np.concatenate([chain, [P - 1]]), np.int32),
        edge_j=to(np.concatenate([chain + 1, [0]]), np.int32),
        edge_T=to(np.concatenate([rel, loop_T[None]]), np.float32),
        edge_weight=to(np.ones(P), np.float32),
        fixed=to(np.arange(P) == 0, bool))
    poses, trace = optimize_pose_graph(prob, PoseGraphConfig(iters=20))
    poses2, _ = optimize_pose_graph(prob, PoseGraphConfig(iters=20))
    tr = trace.cpu().numpy()
    out = poses.cpu().numpy()
    before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    after = np.linalg.norm(out[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    gap = lambda ps: float(np.linalg.norm(  # noqa: E731
        (np.linalg.inv(ps[-1]) @ ps[0] - loop_T)[:3, 3]))
    say(f"  ring of {P}: cost {tr[0]:.3e} -> {tr[-1]:.3e}; worst position error "
        f"{before:.4f} -> {after:.4f} m; loop gap {gap(est):.4f} -> {gap(out):.2e} m")
    if not (np.isfinite(out).all() and tr[-1] < 1e-5 * tr[0] + 1e-8):
        raise SystemExit("FAIL: the pose graph's cost did not drop")
    if not (after < 0.3 * before and gap(out) < 0.05 * gap(est)):
        raise SystemExit("FAIL: the pose graph did not close the loop")
    if not torch.equal(poses, poses2):
        raise SystemExit("FAIL: a second pose-graph run gave other poses")
    return {"nodes": P, "cost_initial": float(tr[0]), "cost_final": float(tr[-1]),
            "max_pos_err_before": float(before), "max_pos_err_after": float(after)}


def ba_work(inputs) -> dict:
    """(bytes, f32 operations) K2 and K3 need on THESE inputs: every input
    read once, every output written once; operations counted per OBSERVED
    slot (an empty slot needs none) and, for the Schur product, per landmark
    over the (6n) x (6n+1) block its n observing poses span, one triangle
    of it (the product is symmetric)."""
    P, L = inputs[0].shape[0], inputs[1].shape[1]
    n_l = inputs[2][4].sum(0).long()                # observed poses per landmark
    slots = int(n_l.sum())
    common_in = 4 * (12 * P + 3 * L + 5 * P * L + L + 8)
    # per observed slot: camera point 18, projection/residual/Huber 23,
    # weighted J_proj and residual 16, Jp 11, Jl 21 (= 89);
    # Hll 36, bl 18; G 90, Gh 90; Hpp block (21 unique) 126, bp 36
    k2_slot = 89 + 54 + 180 + 162
    k2_lm = int((40 + 3 * (6 * n_l) * (6 * n_l + 1) + 36 * n_l).sum())
    # K3 per observed slot: the planes 89, Jp dxp 33, Jl^T u 18; per
    # landmark the 3x3 product and the mask, 18
    k3_slot = 89 + 33 + 18
    return {
        "fused_normal_schur": (
            common_in + 4 * (36 * P + 36 * P * P + 12 * P + 12 * L),
            slots * k2_slot + k2_lm),
        "fused_backsub": (
            common_in + 4 * (12 * L + 6 * P) + 4 * 3 * L,
            slots * k3_slot + 18 * L),
    }


def phase_ba_kernel_times(dev, floor_ms: float) -> dict:
    """K2 and K3 at (8, 4096) and (8, 16384): device ms per launch, the plain
    version's, and the bound counted from the inputs, beside the empty-kernel
    floor."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_ba
    from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba

    out = {"fused_normal_schur": [], "fused_backsub": []}
    for L in (4096, 16384):
        inp = ba_kernel_inputs(*make_synthetic_ba(8, L, 6), 1e-3)
        hll_inv, bl = fused_ba.fused_normal_schur(*inp)[4:]
        dxp = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1e-2, (8, 6)).astype(np.float32)).to(dev)
        k3_in = (*inp, hll_inv, bl, dxp)
        work = ba_work(inp)
        for name, fn, ref, args_ in (
                ("fused_normal_schur", fused_ba.fused_normal_schur,
                 fused_ba.fused_normal_schur_reference, inp),
                ("fused_backsub", fused_ba.fused_backsub,
                 fused_ba.fused_backsub_reference, k3_in)):
            before = fn.launches
            readings = [time_launches(lambda: fn(*args_), reps=20, batch=20)]
            assert fn.launches > before
            ms = min(readings)
            plain_ms = time_launches(lambda: ref(*args_), reps=10, batch=2)
            n_bytes, n_ops = work[name]
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / F32_OPS_PER_S * 1e3
            row = {"shape": [8, L], "ms": ms, "readings_ms": readings,
                   "plain_ms": plain_ms, "floor_ms": floor_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "bytes": n_bytes, "operations": n_ops}
            out[name].append(row)
            say(f"  {name} (P 8, L {L}): kernel {ms:.5f} ms on the card; "
                f"plain {plain_ms:.4f} ms, floor {floor_ms * 1e3:.3f} us, bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {n_bytes} B, "
                f"{n_ops} f32 ops)")
    return out


# ---------------------------------------------------------------------------
# K4 (extract_patches_fused, patch_gather) and the SLAM paths
# ---------------------------------------------------------------------------

def _frame_pyramid(shape, levels, k, dev):
    """Pyramid levels and keypoints of one rendered frame, as the front-end
    makes them."""
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models import frontend
    from jetracer_orbslam2_torch.ops import preprocess

    cfg = FrontendConfig(height=shape[0], width=shape[1], num_levels=levels,
                         max_keypoints=k)
    gray = generate_sequence(2, shape, device=dev).gray[1]
    pyramid = preprocess.build_pyramid(preprocess.gaussian_blur_3x3(gray), levels)
    kp, _, _ = frontend.extract_features(gray, cfg)
    return pyramid, kp


def _forced_keypoints(pyramid, k, seed, level=None):
    """K keypoints drawn from numpy with `seed`: on `level` (every level
    when None), at level-local positions from well outside each level to
    well past it, so that windows clamp, leave small levels and wrap."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops.nms import Keypoints

    dev = pyramid[0].device
    rng = np.random.default_rng(seed)
    n_lv = len(pyramid)
    lv = (np.full(k, level) if level is not None
          else rng.integers(0, n_lv, k)).astype(np.int32)
    hw = np.array([im.shape for im in pyramid])[lv]             # (K, 2) h, w
    xy = np.stack([rng.integers(-40, hw[:, 1] + 40),
                   rng.integers(-40, hw[:, 0] + 40)], -1).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return Keypoints(xy=to(xy.astype(np.float32)), xy_level=to(xy), level=to(lv),
                     score=torch.ones(k, device=dev),
                     valid=torch.zeros(k, dtype=torch.bool, device=dev))


def _check_levels_entry(name, pyramid, kp) -> tuple:
    """K4's levels entry against the plain version, torch.equal, twice; one
    launch a call.  Returns the largest absolute difference and whether both
    launches equal the plain version."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_patches, patches

    ref = patches.extract_patches(pyramid, kp, PATCH)
    before = fused_patches.extract_patches_fused.launches
    got = fused_patches.extract_patches_fused(pyramid, kp, PATCH)
    again = fused_patches.extract_patches_fused(pyramid, kp, PATCH)
    torch.cuda.synchronize()
    launched = fused_patches.extract_patches_fused.launches - before
    if got.shape != ref.shape or launched != (2 if kp.level.numel() else 0):
        raise SystemExit(f"FAIL: extract_patches_fused gave shape "
                         f"{tuple(got.shape)} in {launched} launches at {name}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    equal = torch.equal(got, ref) and torch.equal(got, again)
    say(f"  kernel vs plain  levels entry: {name:44s} K {kp.level.numel():5d}  "
        f"max_abs_err {err:g}  equal {equal}")
    if not equal:
        raise SystemExit(f"FAIL: extract_patches_fused disagrees with "
                         f"extract_patches at {name}")
    return err, equal


def phase_patch_kernel_checks(dev) -> tuple:
    """K4 vs its plain versions, bit for bit: the levels entry (the
    front-end's) against `patches.extract_patches` on rendered frames, on a
    pyramid with levels smaller than the patch, at K = 1 and 0, on 1 and 8
    levels; the canvas entry against `patch_gather_reference` on the packed
    canvas and adversarial origins.  Returns the largest absolute
    difference, the AND of torch.equal over all cases, and the 640x480
    pyramid and keypoints for the timing phase."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_patches, patches, preprocess

    full = None
    max_err, all_equal = 0.0, True
    for shape, levels, k in (((480, 640), 4, 1024), ((240, 320), 3, 512),
                             ((120, 160), 2, 256)):
        pyramid, kp = _frame_pyramid(shape, levels, k, dev)
        pyramid = [im.contiguous() for im in pyramid]
        full = full or (pyramid, kp)
        label = f"{shape[1]}x{shape[0]}, {levels} levels ({int(kp.valid.sum())} valid)"
        err, equal = _check_levels_entry(label, pyramid, kp)
        max_err, all_equal = max(max_err, err), all_equal and equal
        # the canvas entry through PR 4's route on the same frame
        canvas, offsets = patches.pack_levels(pyramid)
        ys, xs = fused_patches.patch_origins(pyramid, offsets, kp, PATCH)
        got = fused_patches.patch_gather(canvas.contiguous(), ys, xs, PATCH)
        torch.cuda.synchronize()
        equal = torch.equal(got, patches.extract_patches(pyramid, kp, PATCH))
        all_equal = all_equal and equal
        if not equal:
            raise SystemExit(f"FAIL: the canvas route disagrees at {shape}")

    def blurred(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        img = torch.rand(shape, generator=g, device=dev) * 255.0
        return preprocess.gaussian_blur_3x3(img)

    small = [im.contiguous() for im in preprocess.build_pyramid(blurred((120, 160), 1), 5)]
    eight = [im.contiguous() for im in preprocess.build_pyramid(blurred((480, 640), 2), 8)]
    one = [blurred((96, 200), 3).contiguous()]
    say(f"  small pyramid: {[tuple(im.shape) for im in small]}; "
        f"8 levels: {[tuple(im.shape) for im in eight]}")
    cases = [
        ("5 levels of 120x160, all on the last", small,
         _forced_keypoints(small, 300, 1, level=4)),
        ("5 levels of 120x160, any level", small, _forced_keypoints(small, 1024, 2)),
        ("K = 1", full[0], _forced_keypoints(full[0], 1, 3)),
        ("K = 0", full[0], _forced_keypoints(full[0], 0, 4)),
        ("1 level (96x200)", one, _forced_keypoints(one, 777, 5)),
        ("8 levels of 480x640", eight, _forced_keypoints(eight, 1024, 6)),
        ("8 levels of 480x640, all on the last", eight,
         _forced_keypoints(eight, 64, 7, level=7)),
    ]
    for name, pyramid, kp in cases:
        err, equal = _check_levels_entry(name, pyramid, kp)
        max_err, all_equal = max(max_err, err), all_equal and equal

    canvas, _ = patches.pack_levels(full[0])
    canvas = canvas.contiguous()
    rows, cols = canvas.shape
    i32 = dict(dtype=torch.int32, device=dev)
    cases = {
        "corners": ([0, 0, rows - PATCH, rows - PATCH], [0, cols - PATCH, 0, cols - PATCH]),
        "one pixel x1024": ([123] * 1024, [456] * 1024),
        "K = 1": ([rows // 2], [cols // 2]),
        "windows off the canvas": ([-5, rows - 3, 40], [-7, 10, cols - 2]),
    }
    for name, (ys, xs) in cases.items():
        ys, xs = torch.tensor(ys, **i32), torch.tensor(xs, **i32)
        before = fused_patches.patch_gather.launches
        got = fused_patches.patch_gather(canvas, ys, xs, PATCH)
        again = fused_patches.patch_gather(canvas, ys, xs, PATCH)
        ref = fused_patches.patch_gather_reference(canvas, ys, xs, PATCH)
        torch.cuda.synchronize()
        equal = torch.equal(got, ref) and torch.equal(got, again)
        err = float((got - ref).abs().max())
        max_err, all_equal = max(max_err, err), all_equal and equal
        say(f"  kernel vs plain  canvas entry: {name:24s} max_abs_err {err:g}  "
            f"equal {equal}")
        if not equal or fused_patches.patch_gather.launches != before + 2:
            raise SystemExit(f"FAIL: patch_gather disagrees at {name}")
    origins = torch.zeros(4, **i32)
    kp = full[1]
    f64 = [im.double() for im in full[0]]
    for bad in (lambda: fused_patches.patch_gather(canvas.double(), origins, origins, PATCH),
                lambda: fused_patches.patch_gather(canvas.T, origins, origins, PATCH),
                lambda: fused_patches.patch_gather(canvas, origins.long(), origins.long(), PATCH),
                lambda: fused_patches.patch_gather(canvas, origins.cpu(), origins, PATCH),
                lambda: fused_patches.extract_patches_fused([], kp, PATCH),
                lambda: fused_patches.extract_patches_fused(eight + one, kp, PATCH),
                lambda: fused_patches.extract_patches_fused(f64, kp, PATCH),
                lambda: fused_patches.extract_patches_fused(
                    full[0], kp._replace(xy_level=kp.xy_level.long()), PATCH),
                lambda: fused_patches.extract_patches_fused(
                    full[0][:-1] + [full[0][-1].cpu()], kp, PATCH)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAIL: a patch wrapper accepted an input the kernel does not take")
    return max_err, all_equal, full


def _empty_launcher():
    """The empty kernel of csrc/patch_gather.cu (one block of one thread that
    does nothing), launched on the current stream."""
    import ctypes
    import torch
    from jetracer_orbslam2_torch.utils import cuda_build

    fn = cuda_build.load_library("patch_gather").empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise SystemExit("FAIL: the empty kernel did not launch")
    return launch


def launch_floor_ms() -> float:
    """Device ms of one empty launch through `time_launches`: the floor under
    every timed launch of phases 6, 11 and 16."""
    return time_launches(_empty_launcher(), reps=20, batch=20)


def phase_patch_kernel_time(pyramid, kp, floor_ms: float) -> dict:
    """K4 at the main path's shape (frame 0's 640x480 pyramid, K 1024, P 37),
    in one run: the levels kernel (read first and again last), the canvas
    entry alone, PR 4's whole route
    (pack_levels + patch_origins + the canvas kernel, one captured graph),
    the plain version, one indexing call with its index prebuilt, a plain
    copy of as many bytes as the output, and the bound of the levels
    kernel."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_patches, patches

    def levels_ms():
        return time_launches(lambda: fused_patches.extract_patches_fused(
            pyramid, kp, PATCH), reps=20, batch=20)

    before = fused_patches.extract_patches_fused.launches
    readings = [levels_ms()]

    canvas, offsets = patches.pack_levels(pyramid)
    canvas = canvas.contiguous()
    ys, xs = fused_patches.patch_origins(pyramid, offsets, kp, PATCH)
    canvas_ms = time_launches(
        lambda: fused_patches.patch_gather(canvas, ys, xs, PATCH), reps=20, batch=20)

    def pr4_route():
        c, off = patches.pack_levels(pyramid)
        y, x = fused_patches.patch_origins(pyramid, off, kp, PATCH)
        return fused_patches.patch_gather(c.contiguous(), y, x, PATCH)
    route_ms = time_launches(pr4_route, reps=20, batch=20)
    plain_ms = time_launches(lambda: patches.extract_patches(pyramid, kp, PATCH),
                             reps=20, batch=4)
    offs = torch.arange(PATCH, device=canvas.device)
    index = ((ys.long()[:, None, None] + offs[None, :, None]) * canvas.shape[1]
             + xs.long()[:, None, None] + offs[None, None, :])
    flat = canvas.reshape(-1)
    if not torch.equal(flat[index], fused_patches.extract_patches_fused(pyramid, kp, PATCH)):
        raise SystemExit("FAIL: the library call does not compute extract_patches")
    library_ms = time_launches(lambda: flat[index], reps=20, batch=20)
    # a yardstick of moving the output alone: one contiguous copy of as
    # many bytes (PyTorch's copy kernel)
    out_a, out_b = torch.empty_like(index, dtype=torch.float32), flat[index]
    copy_ms = time_launches(lambda: out_a.copy_(out_b), reps=20, batch=20)
    readings.append(levels_ms())
    assert fused_patches.extract_patches_fused.launches > before
    ms = min(readings)
    # every input read once (the levels, level and xy_level), the output
    # written once; nothing is computed but addresses
    k = kp.level.numel()
    n_bytes = 4 * (sum(im.numel() for im in pyramid) + 3 * k + k * PATCH * PATCH)
    canvas_bytes = 4 * (canvas.numel() + 2 * k + k * PATCH * PATCH)
    row = {"levels": [list(im.shape) for im in pyramid], "keypoints": k,
           "patch": PATCH, "ms": ms, "readings_ms": readings,
           "canvas_kernel_ms": canvas_ms, "pr4_route_ms": route_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "floor_ms": floor_ms,
           "output_copy_ms": copy_ms,
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": n_bytes, "operations": 0,
           "canvas_bound_ms": canvas_bytes / HBM_BYTES_PER_S * 1e3}
    say(f"  extract_patches_fused, levels {row['levels']}, K {k}, P {PATCH}: "
        f"levels kernel {readings[0] * 1e3:.3f} / {readings[1] * 1e3:.3f} us")
    say(f"  same run: canvas kernel alone {canvas_ms * 1e3:.3f} us (its bound "
        f"{row['canvas_bound_ms'] * 1e3:.3f} us); PR 4's route (pack_levels + "
        f"patch_origins + canvas kernel, one graph) {route_ms * 1e3:.3f} us; plain "
        f"extract_patches {plain_ms * 1e3:.3f} us; one indexing call "
        f"{library_ms * 1e3:.3f} us; a copy of the output's {4 * index.numel()} "
        f"B {copy_ms * 1e3:.3f} us; empty-kernel floor {floor_ms * 1e3:.3f} us; "
        f"bound {row['bound_ms'] * 1e3:.3f} us (bytes: {n_bytes} B)")
    return row


def _kernel_counters() -> dict:
    from jetracer_orbslam2_torch.ops import (
        fused_ba, fused_fast, fused_patches, fused_polish, fused_ransac,
        fused_rigid)

    return {"fast_nms_pyramid": fused_fast.fast_nms_pyramid,
            "extract_patches_fused": fused_patches.extract_patches_fused,
            "patch_gather": fused_patches.patch_gather,
            "fused_normal_schur": fused_ba.fused_normal_schur,
            "fused_backsub": fused_ba.fused_backsub,
            "rigid_fit": fused_rigid.rigid_fit,
            "pose_polish": fused_polish.pose_polish,
            "ransac_select": fused_ransac.ransac_select}


def _k5_k7_short(launches: dict, stepped_frames: int) -> str | None:
    """Why K5's, K6's or K7's launches are off on a SLAM run, or None.  K5:
    at least 2 a stepped frame (the RANSAC refit pair and the map refit
    pair, one launch each; relocalization and loop verification add more,
    as the data decides).  K6: exactly 2 a stepped frame (`track_rgbd`'s
    polish, which runs whether or not the frame tracks, and the map polish
    of `track_and_associate`, map_polish_iters 5; no other caller).  K7: at
    least 1 a stepped frame (`track_rgbd`'s RANSAC; loop verification and
    relocalization add more)."""
    k5, k6 = launches["rigid_fit"], launches["pose_polish"]
    k7 = launches["ransac_select"]
    if k5 < 2 * stepped_frames:
        return f"rigid_fit launched {k5} times, at least {2 * stepped_frames} expected"
    if k6 != 2 * stepped_frames:
        return f"pose_polish launched {k6} times, {2 * stepped_frames} expected"
    if k7 < stepped_frames:
        return f"ransac_select launched {k7} times, at least {stepped_frames} expected"
    return None


def _without_k5_k7(launches: dict, stepped_frames: int, what: str) -> dict:
    """K1-K4's launches; fails unless K5, K6 and K7 ran as a SLAM run's
    stepped frames call them (`_k5_k7_short`)."""
    short = _k5_k7_short(launches, stepped_frames)
    if short:
        raise SystemExit(f"FAIL: {what}: {short}")
    rest = dict(launches)
    for name in ("rigid_fit", "pose_polish", "ransac_select"):
        rest.pop(name)
    return rest


def _reset_counters() -> None:
    for fn in _kernel_counters().values():
        fn.launches = 0


def _read_counters() -> dict:
    return {name: fn.launches for name, fn in _kernel_counters().items()}


def _lap(shape, n_frames, lap_frames, noise, noise_seed, dev):
    """A lap sequence rendered on the card, with depth noise of `noise` x z^2
    from a numpy generator seeded with `noise_seed` (small sequences) or from
    a generator on the card (long ones)."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.io.synthetic import generate_lap_sequence

    seq = generate_lap_sequence(n_frames, shape, lap_frames=lap_frames, device=dev)
    if n_frames * shape[0] * shape[1] <= 32_000_000:
        rnd = torch.from_numpy(np.random.RandomState(noise_seed).randn(
            *seq.depth.shape).astype(np.float32)).to(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(noise_seed)
        rnd = torch.randn(seq.depth.shape, generator=g, device=dev)
    return seq, seq.depth * (1.0 + noise * seq.depth * rnd)


def _scan_pair(firsts, seconds, intr, gt, cfg):
    """init_scan_state + slam_scan over (first, second) stacks (gray + depth,
    or left + right) + one fetch -> (final, out, poses, ATE m)."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models import slam_scan as ss

    state = ss.init_scan_state(firsts[0], seconds[0], intr, cfg)
    final, out = ss.slam_scan(state, firsts[1:], seconds[1:], intr, cfg)
    poses = np.concatenate([final.m.kf_pose[:1].cpu().numpy(),
                            ss.compose_trajectory(final, out)])
    if not np.isfinite(poses).all() or poses.shape != (firsts.shape[0], 4, 4):
        raise SystemExit("FAIL: slam_scan's poses are not finite (N, 4, 4)")
    rmse = float(ate(torch.from_numpy(poses), gt.cpu()).rmse)
    return final, out, poses, rmse


def _scan(seq, depth, cfg):
    """init_scan_state + slam_scan + one fetch -> (final, out, poses, ATE m)."""
    return _scan_pair(seq.gray, depth, seq.intrinsics, seq.poses, cfg)


def _check_obs_prefix(m, what: str) -> None:
    ok = m.obs_valid.cpu().numpy()
    count = int(m.num_obs)
    kf = m.obs_kf.cpu().numpy()[:count]
    if not (ok[:count].all() and not ok[count:].any() and (kf[1:] >= kf[:-1]).all()):
        raise SystemExit(f"FAIL: {what}: obs_kf is not sorted over its valid prefix")


def phase_slam_lap(dev) -> dict:
    """The gated lap: slam_scan and Slam on the same noisy frames, then the
    lap with and without loop closure over LAP_NOISE_SEEDS draws of the noise."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, LoopClosureConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models.slam import Slam

    h, w = LAP_SHAPE
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0))
    seq, depth = _lap(LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE, 0, dev)
    _, _, warm_poses, _ = _scan(seq, depth, cfg)             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, out, poses, rmse = _scan(seq, depth, cfg)
    scan_s = time.perf_counter() - t0
    if not np.array_equal(poses, warm_poses):
        raise SystemExit("FAIL: a second slam_scan with the same seed gave "
                         "other poses (insert, BA, loop closure and the pose "
                         "graph must repeat bit for bit)")
    tracked = out.tracked.cpu().numpy()

    t0 = time.perf_counter()
    slam = Slam(cfg, seq.intrinsics)
    for i in range(LAP_FRAMES):
        slam.process_frame(seq.gray[i], depth[i])
    o = slam.result()
    slam_s = time.perf_counter() - t0
    slam_rmse = float(ate(torch.from_numpy(o.poses), seq.poses.cpu()).rmse)
    if (int(final.num_loops), int(final.m.num_kf), int(final.num_relocs)) != (
            o.num_loops, o.num_keyframes, o.num_relocs):
        raise SystemExit("FAIL: slam_scan and Slam disagree on loops, keyframes "
                         "or relocalizations")
    if not np.array_equal(tracked, o.tracked[1:]):
        raise SystemExit("FAIL: slam_scan and Slam disagree on the tracked flags")
    pose_diff = float(np.abs(poses - o.poses).max())
    if pose_diff > 1e-3 or abs(rmse - slam_rmse) > 1e-3:
        raise SystemExit("FAIL: slam_scan and Slam disagree on the poses")

    # the revisit: frames LAP_LENGTH.. see what frames 0.. saw, from the same
    # places.  What is left between the two, with the loop closed and (the
    # control) with the retrieval gate shut so that no loop can close; over
    # LAP_NOISE_SEEDS draws of the depth noise, since one draw's ATE says little
    def revisit_gap(p):
        return float(np.linalg.norm(
            p[LAP_LENGTH:, :3, 3] - p[:LAP_FRAMES - LAP_LENGTH, :3, 3],
            axis=1).mean())

    open_cfg = cfg.replace(loop=LoopClosureConfig(min_sim=2.0))
    draws = []
    for noise_seed in LAP_NOISE_SEEDS:
        if noise_seed != LAP_NOISE_SEEDS[0]:
            seq, depth = _lap(LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE,
                              noise_seed, dev)
            final, out, poses, rmse = _scan(seq, depth, cfg)
        open_final, _, open_poses, open_rmse = _scan(seq, depth, open_cfg)
        if int(open_final.num_loops) != 0:
            raise SystemExit("FAIL: a loop closed with the retrieval gate shut")
        draws.append({
            "noise_seed": noise_seed, "keyframes": int(final.m.num_kf),
            "loops": int(final.num_loops), "relocs": int(final.num_relocs),
            "tracked_frac": float(out.tracked.float().mean()),
            "ate_rmse_m": rmse, "revisit_gap_mean_m": revisit_gap(poses),
            "no_loop_ate_rmse_m": open_rmse,
            "no_loop_revisit_gap_mean_m": revisit_gap(open_poses)})
    median_ate = statistics.median(d["ate_rmse_m"] for d in draws)
    report = {
        "frames": LAP_FRAMES, "shape": [h, w], "draws": draws,
        "median_ate_rmse_m": median_ate, "ate_limit_m": LAP_ATE_M,
        "no_loop_median_ate_rmse_m": statistics.median(
            d["no_loop_ate_rmse_m"] for d in draws),
        "slam_ate_rmse_m": slam_rmse, "scan_vs_slam_max_pose_diff": pose_diff,
        "scan_fps": LAP_FRAMES / scan_s, "slam_fps": LAP_FRAMES / slam_s,
        "tpu_bar_ate_m": 0.27, "tpu_bar_met": bool(median_ate <= 0.27),
    }
    say("  gated lap: " + json.dumps(report))
    for d in draws:
        if d["tracked_frac"] < 0.95 or d["loops"] < 1:
            raise SystemExit("FAIL: the gated lap lost tracking or closed no loop "
                             f"(noise seed {d['noise_seed']})")
        if not d["revisit_gap_mean_m"] <= 0.5 * d["no_loop_revisit_gap_mean_m"]:
            raise SystemExit("FAIL: closing the loop left more than half of the "
                             f"revisit's gap (noise seed {d['noise_seed']})")
    if not median_ate <= LAP_ATE_M:
        raise SystemExit(f"FAIL: gated lap median ATE {median_ate:.3f} m > "
                         f"{LAP_ATE_M} m")
    return report


def phase_slam_path(dev) -> tuple[dict, dict]:
    """slam_scan at full width over three laps; returns the report and every
    kernel's launch count on the run."""
    import torch
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, MapConfig, SystemConfig, TrackingConfig)

    cfg = SystemConfig(
        frontend=FrontendConfig(height=480, width=640,
                                fast_min_threshold=SLAM_FAST_MIN_THRESHOLD),
        tracking=TrackingConfig(), map=MapConfig(max_keyframes=LONG_KEYFRAMES))
    t0 = time.perf_counter()
    seq, depth = _lap((480, 640), LONG_FRAMES, LONG_LAP, LONG_NOISE, 7, dev)
    torch.cuda.synchronize()
    say(f"  rendered {LONG_FRAMES} frames of 640x480 on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # warm-up on the first frames: every shape of the run has been seen once
    warm = seq._replace(gray=seq.gray[:40], depth=depth[:40], poses=seq.poses[:40])
    _scan(warm, depth[:40], cfg)
    _reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with counting_calls() as calls:
        start.record()
        final, out, poses, rmse = _scan(seq, depth, cfg)
        stop.record()
        stop.synchronize()
    launches = _read_counters()
    ms = start.elapsed_time(stop)
    inserted = int(out.is_kf.sum())
    m = final.m
    k1_k4 = _without_k5_k7(launches, LONG_FRAMES - 1, "SLAM path")
    report = {
        "frames": LONG_FRAMES, "shape": [480, 640], "levels": 4, "keypoints": 1024,
        "map_capacity": [LONG_KEYFRAMES, int(m.lm_valid.shape[0]),
                         int(m.obs_valid.shape[0])],
        "tracked_frac": float(out.tracked.float().mean()),
        "loops": int(final.num_loops), "relocs": int(final.num_relocs),
        "keyframes": int(m.num_kf), "keyframes_inserted": inserted,
        "keyframes_recycled": int(m.num_dead), "landmarks": int(m.num_lm),
        "observations": int(m.num_obs), "ate_rmse_m": rmse,
        "ms_per_frame": ms / LONG_FRAMES, "fps": LONG_FRAMES / (ms / 1e3),
        "launches": launches, "k4_route_calls": calls,
    }
    say("  SLAM path: " + json.dumps(report))
    if report["tracked_frac"] < 0.95 or report["loops"] < 1:
        raise SystemExit("FAIL: the SLAM path lost tracking or closed no loop")
    if not rmse <= LONG_ATE_M:
        raise SystemExit(f"FAIL: SLAM path ATE {rmse:.3f} m > {LONG_ATE_M} m")
    if not (report["landmarks"] < m.lm_valid.shape[0]
            and report["observations"] < m.obs_valid.shape[0]):
        raise SystemExit("FAIL: the map ran out of landmark or observation slots")
    want = {"fast_nms_pyramid": LONG_FRAMES, "extract_patches_fused": LONG_FRAMES,
            "patch_gather": 0,
            "fused_normal_schur": 10 * inserted, "fused_backsub": 10 * inserted}
    if k1_k4 != want:
        raise SystemExit(f"FAIL: SLAM path launches {launches}, expected {want}")
    if any(calls.values()):
        raise SystemExit(f"FAIL: the SLAM path packed a canvas: {calls}")
    _check_obs_prefix(m, "SLAM path")
    return report, launches


def phase_map_lifecycle(dev) -> dict:
    """Three laps through a map of 32 keyframe slots: compact_keyframes must
    recycle slots while tracking holds and every frame keeps a pose."""
    import numpy as np
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.models.backend import map as map_mod

    h, w = LAP_SHAPE
    n_frames = 3 * LAP_LENGTH + 16
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0),
        map=MapConfig(max_keyframes=32))
    seq, depth = _lap(LAP_SHAPE, n_frames, LAP_LENGTH, LAP_NOISE, 0, dev)
    final, out, poses, rmse = _scan(seq, depth, cfg)
    m = final.m
    table = map_mod.resolve_kf_poses(m)
    ref = out.ref_uid.cpu().numpy()
    live_uids = set(m.kf_frame_id.cpu().numpy()[:int(m.num_kf)].tolist())
    resolved = int(sum(int(u) in table for u in ref))
    through_ring = int(sum(int(u) in table and int(u) not in live_uids for u in ref))
    tracked = out.tracked.cpu().numpy()
    report = {
        "frames": n_frames, "keyframe_slots": 32, "keyframes": int(m.num_kf),
        "keyframes_inserted": int(out.is_kf.sum()),
        "keyframes_recycled": int(m.num_dead), "loops": int(final.num_loops),
        "tracked_frac": float(tracked.mean()),
        "tracked_last_50": float(tracked[-50:].mean()), "ate_rmse_m": rmse,
        "frames_resolved": resolved, "frames_through_retired_ring": through_ring,
        "frames_fallen_back": int(ref.shape[0]) - resolved,
    }
    say("  lifecycle: " + json.dumps(report))
    if report["keyframes_recycled"] <= 0 or report["keyframes"] > 32:
        raise SystemExit("FAIL: no keyframe slot was recycled")
    if through_ring <= 0:
        raise SystemExit("FAIL: no frame rode a retired keyframe")
    if report["tracked_last_50"] < 0.8 or report["tracked_frac"] < 0.9:
        raise SystemExit("FAIL: tracking did not hold to the end")
    newest = int(m.kf_frame_id.cpu().numpy()[int(m.num_kf) - 1])
    if newest < 0.9 * n_frames:
        raise SystemExit("FAIL: mapping froze before the end of the run")
    _check_obs_prefix(m, "lifecycle")
    return report


def phase_cli() -> list:
    """The CLI at its default mode, whole and chunked."""
    import contextlib
    import io
    import math
    from jetracer_orbslam2_torch import run

    reports = []
    for extra in ([], ["--chunked", "8"]):
        argv = ["--synthetic", "60", "--json", "--log-level", "warning"] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = run.main(argv)
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        say(f"  run.main({argv}) -> {code}: " + json.dumps(report))
        if code != 0 or not report["mode"].startswith("slam"):
            raise SystemExit("FAIL: the CLI's default mode did not run the SLAM system")
        if not (math.isfinite(report["ate_rmse_m"]) and report["ate_rmse_m"] < 0.10
                and report["tracked_frac"] >= 0.95 and report["keyframes"] >= 2):
            raise SystemExit("FAIL: the CLI's SLAM report is off")
        reports.append(report)
    return reports


# ---------------------------------------------------------------------------
# stereo and datasets
# ---------------------------------------------------------------------------

def _stereo_pyramids(dev):
    """Frame 0 of the stereo arc at 640x480 on the card, and the 4-level
    pyramids of its left and right images, as the front-end makes them."""
    from jetracer_orbslam2_torch.io.synthetic import generate_stereo_sequence
    from jetracer_orbslam2_torch.ops import preprocess

    seq = generate_stereo_sequence(1, (480, 640), baseline=STEREO_BASELINE,
                                   device=dev)
    return seq, [[l.contiguous() for l in preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(img), 4)] for img in (seq.left[0],
                                                           seq.right[0])]


def phase_k1_stereo_batch(dev, floor_ms: float) -> dict:
    """K1 for a stereo frame at two thresholds: one launch per image (4 levels
    each) against one launch of both images' 8 levels, in turns (two, one,
    one, two); the outputs must be torch.equal."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_fast

    _, (left, right) = _stereo_pyramids(dev)
    thr = (FAST_THRESHOLD, SLAM_FAST_MIN_THRESHOLD)

    def per_image():
        return (fused_fast.fast_nms_pyramid(left, thr, FAST_ARC, FAST_BORDER),
                fused_fast.fast_nms_pyramid(right, thr, FAST_ARC, FAST_BORDER))

    def one_launch():
        return fused_fast.fast_nms_pyramid(left + right, thr, FAST_ARC,
                                           FAST_BORDER)

    two, one = per_image(), one_launch()
    torch.cuda.synchronize()
    n = len(left)
    equal = all(torch.equal(one[j][i], two[0][j][i])
                and torch.equal(one[j][n + i], two[1][j][i])
                for j in range(len(thr)) for i in range(n))
    if not equal:
        raise SystemExit("FAIL: one launch of both pyramids differs from one "
                         "launch per image")
    two_ms = [time_launches(per_image, reps=20, batch=20)]
    one_ms = [time_launches(one_launch, reps=20, batch=20) for _ in range(2)]
    two_ms.append(time_launches(per_image, reps=20, batch=20))
    n_bytes, n_ops = fast_nms_work(left + right, thr, FAST_BORDER)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    row = {"levels": [list(l.shape) for l in left + right],
           "thresholds": list(thr), "equal": equal,
           "per_image_ms": min(two_ms), "per_image_readings_ms": two_ms,
           "one_launch_ms": min(one_ms), "one_launch_readings_ms": one_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": n_bytes, "operations": n_ops, "floor_ms": floor_ms}
    say(f"  stereo frame (2 x 4 levels of 640x480, 2 thresholds): two launches "
        f"{' / '.join(f'{t * 1e3:.2f}' for t in two_ms)} us, one launch of 8 "
        f"levels {' / '.join(f'{t * 1e3:.2f}' for t in one_ms)} us; outputs "
        f"torch.equal: {equal}; bound {row['bound_ms'] * 1e3:.3f} us "
        f"({row['bound_by']})")
    return row


def _stereo_agreement(gpu, cpu, what: str) -> dict:
    """GPU against CPU stereo features, held as phase 4 holds the RGB-D
    front-end (keypoint fields torch.equal, descriptors on >= 99 % of valid
    keypoints), plus the stereo depth as the CPU parity tests hold it against
    the JAX package (has_point on >= 99 %, points rtol 1e-5 where both)."""
    import torch

    for name in ("xy", "level", "score", "valid"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise SystemExit(f"FAIL: {what}: stereo field {name} differs "
                             "between GPU and CPU")
    valid = cpu.valid
    same = (gpu.desc.cpu() == cpu.desc).all(-1)[valid]
    desc_frac = float(same.float().mean())
    hp = float((gpu.has_point.cpu() == cpu.has_point).float().mean())
    both = gpu.has_point.cpu() & cpu.has_point
    pg, pc = gpu.points.cpu()[both], cpu.points[both]
    rel = float(((pg - pc).abs() / pc.abs().clamp_min(1e-30)).max()) if len(pc) else 0.0
    out = {"valid": int(valid.sum()), "desc_equal_frac": desc_frac,
           "desc_torch_equal": bool(torch.equal(gpu.desc.cpu(), cpu.desc)),
           "has_point_agree": hp, "has_point": int(cpu.has_point.sum()),
           "points_max_rel": rel}
    say(f"  {what}: " + json.dumps(out))
    if desc_frac < 0.99 or hp < 0.99 or rel > 1e-5:
        raise SystemExit(f"FAIL: {what}: stereo features differ between GPU and CPU")
    return out


def phase_stereo_check(dev) -> dict:
    """frontend_stereo on a 640x480 rendered pair, on the card and on the CPU;
    the second card call under set_sync_debug_mode("error"); launches per
    call."""
    import torch
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.models.frontend import extract_features
    from jetracer_orbslam2_torch.models.stereo import (
        extract_features_pair, frontend_stereo)

    seq, _ = _stereo_pyramids(dev)
    left, right = torch.round(seq.left[0]), torch.round(seq.right[0])
    cfg = FrontendConfig(height=480, width=640,
                         fast_min_threshold=SLAM_FAST_MIN_THRESHOLD)
    args = (seq.intrinsics, STEREO_BASELINE, cfg)
    frontend_stereo(left, right, *args)              # tables, first launches
    torch.cuda.synchronize()
    _reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu = frontend_stereo(left, right, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    per_call = _read_counters()
    cpu = frontend_stereo(left.cpu(), right.cpu(), seq.intrinsics.cpu(),
                          STEREO_BASELINE, cfg, device="cpu")
    out = _stereo_agreement(gpu, cpu, "frontend_stereo 640x480, GPU vs CPU")
    # both pyramids as one K1 level list (one launch for every 8 levels)
    # against one launch an image, on the card: at 4 levels (one launch) and
    # at 5 (launches of 8 and 2)
    out["pair_k1_launches"] = {}
    for levels in (4, 5):
        lcfg = dataclasses.replace(cfg, num_levels=levels)
        _reset_counters()
        pair = extract_features_pair(left, right, lcfg)
        k1 = _read_counters()["fast_nms_pyramid"]
        for img, got in zip((left, right), pair):
            ref = extract_features(img, lcfg)
            same = [torch.equal(a, b) for a, b in zip(got[0], ref[0])]
            if not (all(same) and torch.equal(got[1], ref[1])
                    and torch.equal(got[2], ref[2])):
                raise SystemExit(f"FAIL: the stereo pair's extraction at "
                                 f"{levels} levels differs from one launch "
                                 "an image")
        if k1 != -(-2 * levels // 8):
            raise SystemExit(f"FAIL: the stereo pair at {levels} levels made "
                             f"{k1} K1 launches")
        out["pair_k1_launches"][levels] = k1
    out["pair_equals_per_image"] = True
    say("  extract_features_pair torch.equal to extract_features on each "
        "image; K1 launches of the pair at 4 / 5 levels: "
        f"{out['pair_k1_launches'][4]} / {out['pair_k1_launches'][5]}")
    out["launches_per_call"] = per_call
    say(f"  launches of one frontend_stereo call (under "
        f"set_sync_debug_mode('error'), no host wait): {json.dumps(per_call)}")
    want = {"fast_nms_pyramid": STEREO_K1_PER_FRAME, "extract_patches_fused": 2,
            "rigid_fit": 0, "pose_polish": 0, "ransac_select": 0,
            "patch_gather": 0, "fused_normal_schur": 0, "fused_backsub": 0}
    if per_call != want:
        raise SystemExit(f"FAIL: frontend_stereo launched {per_call}, expected {want}")
    return out


def phase_stereo_path(dev) -> dict:
    """bench.py's stereo workload at full width through slam_scan: the arc and
    the lap, each timed after a warm-up, with every kernel's launches."""
    import torch
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.io.synthetic import (
        generate_stereo_lap_sequence, generate_stereo_sequence)

    cfg = SystemConfig(
        frontend=FrontendConfig(height=480, width=640,
                                fast_min_threshold=SLAM_FAST_MIN_THRESHOLD),
        tracking=TrackingConfig(max_depth=80.0),
        stereo=StereoConfig(baseline=STEREO_BASELINE))
    t0 = time.perf_counter()
    seqs = {
        "arc": generate_stereo_sequence(STEREO_FRAMES, (480, 640),
                                        baseline=STEREO_BASELINE, device=dev),
        "lap": generate_stereo_lap_sequence(STEREO_FRAMES, (480, 640),
                                            lap_frames=STEREO_LAP,
                                            baseline=STEREO_BASELINE, device=dev),
    }
    torch.cuda.synchronize()
    say(f"  rendered 2 x {STEREO_FRAMES} stereo pairs of 640x480 on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    warm = seqs["arc"]
    _scan_pair(warm.left[:30], warm.right[:30], warm.intrinsics,
               warm.poses[:30], cfg)
    report = {}
    for name, seq in seqs.items():
        _reset_counters()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with counting_calls() as calls:
            start.record()
            final, out, poses, rmse = _scan_pair(seq.left, seq.right,
                                                 seq.intrinsics, seq.poses, cfg)
            stop.record()
            stop.synchronize()
        launches = _read_counters()
        ms = start.elapsed_time(stop)
        inserted = int(out.is_kf.sum())
        row = {
            "frames": STEREO_FRAMES, "shape": [480, 640], "levels": 4,
            "keypoints": 1024, "baseline_m": STEREO_BASELINE,
            "tracked_frac": float(out.tracked.float().mean()),
            "loops": int(final.num_loops), "relocs": int(final.num_relocs),
            "keyframes": int(final.m.num_kf), "keyframes_inserted": inserted,
            "landmarks": int(final.m.num_lm), "ate_rmse_m": rmse,
            "ate_limit_m": STEREO_ATE_M[name],
            "ms_per_frame": ms / STEREO_FRAMES, "fps": STEREO_FRAMES / (ms / 1e3),
            "launches": launches, "k4_route_calls": calls,
        }
        say(f"  stereo {name}: " + json.dumps(row))
        if not rmse <= STEREO_ATE_M[name]:
            raise SystemExit(f"FAIL: stereo {name} ATE {rmse:.3f} m > "
                             f"{STEREO_ATE_M[name]} m")
        if name == "lap" and row["tracked_frac"] < 0.95:
            raise SystemExit("FAIL: the stereo lap lost tracking")
        if (row["loops"], row["keyframes"]) != STEREO_OUTCOME[name]:
            raise SystemExit(
                f"FAIL: stereo {name} closed {row['loops']} loops with "
                f"{row['keyframes']} keyframes; the reference gives "
                f"{STEREO_OUTCOME[name]}")
        want = {"fast_nms_pyramid": STEREO_K1_PER_FRAME * STEREO_FRAMES,
                "extract_patches_fused": 2 * STEREO_FRAMES, "patch_gather": 0,
                "fused_normal_schur": 10 * inserted,
                "fused_backsub": 10 * inserted}
        k1_k4 = _without_k5_k7(launches, STEREO_FRAMES - 1, f"stereo {name}")
        if k1_k4 != want or any(calls.values()):
            raise SystemExit(f"FAIL: stereo {name} launches {launches} (calls "
                             f"{calls}), expected {want}")
        report[name] = row
    return report


def _align_agreement(gpu, cpu, raw, di, ci, T) -> dict:
    """align_depth_to_color on the card against the CPU: >= 99.9 % of pixels
    equal, and every other pixel next to a depth pixel whose colour-frame
    position (recomputed in float64) lies within 1e-3 px of a rounding edge
    (x.5), where an ulp of f32 may round either way."""
    import numpy as np

    g, c = gpu.cpu().numpy(), cpu.numpy()
    diff = g != c
    frac = 1.0 - float(diff.mean())
    fx, fy, cx, cy = (float(v) for v in di)
    h, w = raw.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    z = raw.astype(np.float64)
    pts = np.stack([(xx - cx) / fx * z, (yy - cy) / fy * z, z], -1)
    T = np.asarray(T, np.float64).reshape(4, 4)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    zc = np.where(np.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    u = pc[..., 0] / zc * float(ci[0]) + float(ci[2])
    v = pc[..., 1] / zc * float(ci[1]) + float(ci[3])
    edge = ((np.abs(u - np.floor(u) - 0.5) < 1e-3)
            | (np.abs(v - np.floor(v) - 0.5) < 1e-3)) & (z > 0)
    near = np.zeros_like(diff)
    for uu, vv in zip(np.floor(u[edge]).astype(int), np.floor(v[edge]).astype(int)):
        near[max(vv - 1, 0):vv + 3, max(uu - 1, 0):uu + 3] = True
    unexplained = int((diff & ~near[:h, :w]).sum())
    return {"pixels_equal_frac": frac, "pixels_differing": int(diff.sum()),
            "differing_off_a_rounding_edge": unexplained}


def phase_datasets() -> dict:
    """Every fixture through run.main on the card, with the CPU tests' bars;
    which PNG decoder served; align_depth_to_color on the card vs the CPU;
    K1/K4 launches a frame."""
    import contextlib
    import io
    import os
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.io import datasets, native_loader
    from jetracer_orbslam2_torch.ops.align import align_depth_to_color

    if not native_loader.available():
        raise SystemExit("FAIL: the native PNG decoder did not build: "
                         f"{native_loader.build_error()}")
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures")
    narrow = ["--levels", "3", "--max-keypoints", "256"]
    # (name, fixture, extra argv, env, stereo, bars)
    runs = [
        ("tum_tiny", "tum_tiny", narrow, {}, False, {"ate": 0.05, "tracked": 0.9}),
        ("tum_tiny (PIL)", "tum_tiny", narrow,
         {"JETRACER_DISABLE_NATIVE": "1"}, False, {"ate": 0.05}),
        ("tum_tiny_unaligned", "tum_tiny_unaligned",
         ["--levels", "2", "--max-keypoints", "128"], {}, False,
         {"ate": 0.05, "tracked": 0.9}),
        ("euroc_tiny", "euroc_tiny/mav0", narrow, {}, True,
         {"ate": 0.2, "tracked": 0.9, "roll": 1.0}),
        ("euroc_tiny --chunked 4", "euroc_tiny/mav0",
         narrow + ["--chunked", "4", "--fast-min-threshold", "7"], {}, True,
         {"ate": 0.2}),
        ("euroc_tiny_dist", "euroc_tiny_dist/mav0", narrow, {}, True, {"ate": 0.2}),
        ("kitti_tiny", "kitti_tiny", narrow, {}, True,
         {"ate": 0.06, "tracked": 0.9}),
        ("kitti_tiny --chunked 4", "kitti_tiny", narrow + ["--chunked", "4"], {},
         True, {"ate": 0.06, "tracked": 0.9}),
    ]
    out = {}
    for name, sub, extra, env, stereo, bars in runs:
        argv = ["--dataset", os.path.join(fix, sub), "--json",
                "--log-level", "warning"] + extra
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        before = dict(datasets.DECODED)
        _reset_counters()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                code = run.main(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = _read_counters()
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        served = {k: datasets.DECODED[k] - before[k] for k in before}
        frames = report["frames"]
        report.update(decoder=served,
                      k1_per_frame=launches["fast_nms_pyramid"] / frames,
                      k4_per_frame=launches["extract_patches_fused"] / frames,
                      ba_launches=launches["fused_normal_schur"])
        say(f"  {name}: exit {code}: " + json.dumps(report))
        per_frame = 2 if stereo else 1
        bad = []
        if code != 0 or report["device"] != "cuda:0":
            bad.append("did not run on the card")
        if report.get("stereo") is not stereo:
            bad.append("stereo flag")
        if not report["ate_rmse_m"] < bars["ate"]:
            bad.append(f"ATE {report['ate_rmse_m']} >= {bars['ate']}")
        if "tracked" in bars and not report["tracked_frac"] > bars["tracked"]:
            bad.append(f"tracked {report['tracked_frac']}")
        if "roll" in bars and not abs(report["attitude_rad"][0]) > bars["roll"]:
            bad.append("the IMU attitude was not consumed")
        want_decoder = "pil" if env else "native"
        if served[want_decoder] <= 0 or sum(served.values()) != served[want_decoder]:
            bad.append(f"decoder {served}, expected {want_decoder} only")
        k1_want = (STEREO_K1_PER_FRAME if stereo else 1) * frames
        if launches["fast_nms_pyramid"] != k1_want:
            bad.append(f"K1 launches {launches['fast_nms_pyramid']} != {k1_want}")
        if launches["extract_patches_fused"] != per_frame * frames:
            bad.append(f"K4 launches {launches['extract_patches_fused']}")
        if bad:
            raise SystemExit(f"FAIL: dataset run {name}: {'; '.join(bad)}")
        out[name] = report

    ds = datasets.open_dataset(os.path.join(fix, "tum_tiny_unaligned"))
    align = []
    for i in (0, len(ds) - 1):
        raw = ds.frame(i).depth
        args = (raw, ds.depth_intrinsics, ds.intrinsics,
                torch.tensor(ds.T_color_depth).reshape(4, 4), raw.shape)
        gpu = align_depth_to_color(*args)
        cpu = align_depth_to_color(*args, device="cpu")
        row = _align_agreement(gpu, cpu, raw, ds.depth_intrinsics, ds.intrinsics,
                               ds.T_color_depth)
        row["frame"] = i
        align.append(row)
        say(f"  align_depth_to_color, frame {i}, card vs CPU: " + json.dumps(row))
        if row["pixels_equal_frac"] < 0.999 or row["differing_off_a_rounding_edge"]:
            raise SystemExit("FAIL: align_depth_to_color differs between the card "
                             "and the CPU beyond the rounding edge")
    out["align_depth_to_color"] = align
    out["native_decoder"] = str(native_loader.library_path().name)
    return out


# ---------------------------------------------------------------------------
# runtime: the --mode slam host loop through FramePipeline, telemetry and
# checkpoint/resume
# ---------------------------------------------------------------------------

def _write_tum_sequence(root: str, n_frames: int, dev) -> None:
    """`n_frames` of 640x480 from the port's `generate_sequence`, written in
    the TUM layout that scripts/make_tum_fixture.py writes: 8-bit RGB PNGs
    (the grey image in three channels), 16-bit depth PNGs at 1/5000 m,
    rgb.txt / depth.txt / groundtruth.txt (TUM quaternion order) and
    intrinsics.txt."""
    import concurrent.futures
    import os
    import numpy as np
    from PIL import Image
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence

    seq = generate_sequence(n_frames=n_frames, shape=(480, 640), device=dev)
    gray = seq.gray.clamp(0, 255).cpu().numpy().astype(np.uint8)
    depth = (seq.depth * 5000.0).clamp(0, 65535).cpu().numpy().astype(np.uint16)
    poses = seq.poses.cpu().numpy()
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    t0 = 1_305_031_100.0
    names = [f"{t0 + i / 30.0:.6f}.png" for i in range(n_frames)]

    def write(i):
        Image.fromarray(np.repeat(gray[i][..., None], 3, -1), mode="RGB").save(
            os.path.join(root, "rgb", names[i]))
        Image.fromarray(depth[i]).save(os.path.join(root, "depth", names[i]))

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n_frames)))     # zlib releases the GIL
    gt_lines = []
    for i, T in enumerate(poses):
        R = T[:3, :3]
        qw = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
        qx = (R[2, 1] - R[1, 2]) / (4 * qw)
        qy = (R[0, 2] - R[2, 0]) / (4 * qw)
        qz = (R[1, 0] - R[0, 1]) / (4 * qw)
        tx, ty, tz = T[:3, 3]
        gt_lines.append(f"{names[i][:-4]} {tx:.6f} {ty:.6f} {tz:.6f} "
                        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    for fname, lines in (
            ("rgb.txt", [f"{nm[:-4]} rgb/{nm}" for nm in names]),
            ("depth.txt", [f"{nm[:-4]} depth/{nm}" for nm in names]),
            ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("# synthetic TUM-layout sequence 640x480\n# timestamp data\n")
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(" ".join(f"{v:.4f}" for v in seq.intrinsics.cpu().numpy()) + "\n")


def _recv_exact(sock, k: int) -> bytes:
    out = b""
    while len(out) < k:
        chunk = sock.recv(k - len(out))
        if not chunk:
            raise ConnectionError("server closed the connection")
        out += chunk
    return out


class _TelemetryClient:
    """A WebSocket client as viewer/index.html is one: connects as soon as
    the server listens, then BSON-decodes every binary frame until the
    server closes the connection."""

    def __init__(self, port: int):
        import threading

        self.port, self.docs, self.error = port, [], None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _connect(self):
        import socket
        from jetracer_orbslam2_torch.runtime.telemetry import _accept_key

        s = socket.create_connection(("127.0.0.1", self.port), timeout=3)
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        s.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{self.port}\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = s.recv(4096)
            if not chunk:
                raise ConnectionError("no handshake")
            resp += chunk
        if b"101" not in resp.split(b"\r\n", 1)[0] or _accept_key(key).encode() not in resp:
            raise ConnectionError(f"bad handshake {resp[:80]!r}")
        return s

    def _run(self):
        import struct
        from jetracer_orbslam2_torch.runtime import bson

        deadline = time.time() + 120
        sock = None
        while sock is None:
            try:
                sock = self._connect()
            except OSError:
                if time.time() > deadline:
                    self.error = "no server within 120 s"
                    return
                time.sleep(0.005)
        sock.settimeout(300)
        try:
            while True:
                hdr = _recv_exact(sock, 2)
                k = hdr[1] & 0x7F
                if k == 126:
                    (k,) = struct.unpack(">H", _recv_exact(sock, 2))
                elif k == 127:
                    (k,) = struct.unpack(">Q", _recv_exact(sock, 8))
                self.docs.append(bson.decode(_recv_exact(sock, k)))
        except (ConnectionError, OSError):
            pass
        finally:
            sock.close()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _RuntimeProbe:
    """Patches, for one run, what phase 20 reads off the host loop: host
    waits (sync-debug "warn") inside a frame's calls (the copy to the card,
    `Slam.features`, `Slam.process_features`, the telemetry publish) and on
    worker threads; frames whose host tensors came pinned; keyframe updates;
    the last `Slam.result()`; decode time of each `TumRGBD.frame` (worker
    threads); JPEG time and bytes; telemetry bytes; and, when a client is
    expected, a wait inside `WebSocketServer.start` (before the timed loop)
    until it has connected."""

    def __init__(self, wait_for_client: bool = False):
        self.wait_for_client = wait_for_client
        self.waits = {"frame": 0, "publish": 0, "other_main": 0, "worker": 0}
        self.depth = 0
        self.publishing = 0
        self.frames_copied = self.frames_pinned = 0
        self.keyframe_updates = 0
        self.result = None
        self.decode_s, self.jpeg_s, self.jpeg_bytes, self.sent_bytes = [], [], [], []

    def __enter__(self):
        import threading
        import warnings
        import torch
        from jetracer_orbslam2_torch import run
        from jetracer_orbslam2_torch.io import datasets
        from jetracer_orbslam2_torch.models import slam as slam_mod
        from jetracer_orbslam2_torch.runtime import telemetry

        probe, main = self, threading.main_thread()
        self._saved = []

        def patch(owner, name, make):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, make(fn))

        def frame_work(fn):
            def wrapped(*a, **kw):
                probe.depth += 1
                try:
                    return fn(*a, **kw)
                finally:
                    probe.depth -= 1
            return wrapped

        def to_device(fn):
            def wrapped(frame, device):
                host = [x for x in frame[:3]
                        if isinstance(x, torch.Tensor) and x.device.type == "cpu"]
                probe.frames_copied += 1
                probe.frames_pinned += all(x.is_pinned() for x in host)
                return frame_work(fn)(frame, device)
            return wrapped

        def publish(fn):
            def wrapped(*a, **kw):
                probe.publishing += 1
                try:
                    return frame_work(fn)(*a, **kw)
                finally:
                    probe.publishing -= 1
            return wrapped

        def counted(fn):
            def wrapped(*a, **kw):
                probe.keyframe_updates += 1
                return fn(*a, **kw)
            return wrapped

        def captured(fn):
            def wrapped(*a, **kw):
                probe.result = fn(*a, **kw)
                return probe.result
            return wrapped

        def timed(into, sizes=None):
            def make(fn):
                def wrapped(*a, **kw):
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    into.append(time.perf_counter() - t0)
                    if sizes is not None:
                        sizes.append(len(out))
                    return out
                return wrapped
            return make

        def broadcast(fn):
            def wrapped(srv, payload):
                probe.sent_bytes.append(len(payload))
                return fn(srv, payload)
            return wrapped

        def start(fn):
            def wrapped(srv):
                out = fn(srv)
                deadline = time.time() + 60
                while srv.num_clients == 0 and time.time() < deadline:
                    time.sleep(0.005)
                if srv.num_clients == 0:
                    raise SystemExit("FAIL: the telemetry client did not connect")
                return out
            return wrapped

        patch(run, "to_device", to_device)
        patch(slam_mod.Slam, "features", frame_work)
        patch(slam_mod.Slam, "process_features", frame_work)
        patch(slam_mod.Slam, "result", captured)
        patch(slam_mod, "keyframe_update", counted)
        patch(datasets.TumRGBD, "frame", timed(self.decode_s))
        patch(telemetry.TelemetryPublisher, "publish", publish)
        patch(telemetry.TelemetryPublisher, "_jpeg", timed(self.jpeg_s, self.jpeg_bytes))
        patch(telemetry.WebSocketServer, "broadcast", broadcast)
        if self.wait_for_client:
            patch(telemetry.WebSocketServer, "start", start)

        def note(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing" not in str(message):
                return
            if threading.current_thread() is not main:
                probe.waits["worker"] += 1
            elif probe.publishing:
                probe.waits["publish"] += 1
            elif probe.depth:
                probe.waits["frame"] += 1
            else:
                probe.waits["other_main"] += 1

        self._showwarning = warnings.showwarning
        self._filters = warnings.filters[:]
        warnings.showwarning = note
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import warnings
        import torch

        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self._showwarning
        warnings.filters[:] = self._filters
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        return False


def _drive_without_pipeline(root: str, dev) -> dict:
    """Run A: the CLI's host loop without its runtime.  The phase drives
    `Slam` over `open_dataset(root)` itself: each frame is loaded (decoded
    and pinned) on this thread, goes to the card as the CLI sends it, then
    through `features` and `process_features`."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import SystemConfig
    from jetracer_orbslam2_torch.models.slam import Slam

    args = run.build_argparser().parse_args(["--dataset", root])
    src = run._open_source(args, dev)
    slam = Slam(SystemConfig(frontend=run._frontend_cfg(args, src.hw, src.cal)),
                src.intr, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(src.n):
        g, d, _, pk = run.to_device(src.load(i), dev)
        slam.process_features(slam.features(g, d), imu_packet=pk)
    out = slam.result()
    wall = time.perf_counter() - t0
    report = {"mode": "slam", "frames": src.n, "fps": src.n / wall,
              "tracked_frac": float(np.mean(out.tracked)),
              "keyframes": out.num_keyframes, "landmarks": out.num_landmarks,
              "loops": out.num_loops, "relocs": out.num_relocs,
              "device": str(dev)}
    run._accuracy(report, out.poses, src.gt, src.n)
    return report


def _cli(argv) -> tuple[int, dict]:
    import contextlib
    import io
    from jetracer_orbslam2_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = run.main(argv + ["--json", "--log-level", "warning"])
    lines = buf.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else {})


def _check_telemetry_doc(doc: dict, k_max: int) -> list:
    import io
    import numpy as np
    from PIL import Image

    bad = [f"missing {f}" for f in ("ax", "ay", "az", "width", "height",
                                    "channels", "keypoints_x", "keypoints_y",
                                    "image", "pose") if f not in doc]
    if bad:
        return bad
    if (doc["width"], doc["height"]) != (640, 480):
        bad.append(f"size {doc['width']}x{doc['height']}")
    kx = np.frombuffer(doc["keypoints_x"], np.int16)
    ky = np.frombuffer(doc["keypoints_y"], np.int16)
    if not 0 < len(kx) == len(ky) <= k_max:
        bad.append(f"{len(kx)} / {len(ky)} keypoints")
    if not ((kx >= 0).all() and (kx < 640).all() and (ky >= 0).all()
            and (ky < 480).all()):
        bad.append("a keypoint outside the image")
    if Image.open(io.BytesIO(doc["image"])).size != (640, 480):
        bad.append("the JPEG does not decode to 640x480")
    pose = np.frombuffer(doc["pose"], np.float32).reshape(4, 4)
    if not np.allclose(pose[3], [0, 0, 0, 1], atol=1e-6):
        bad.append(f"pose last row {pose[3]}")
    return bad


def _overlay_card_vs_cpu(root: str, dev) -> dict:
    """`overlay_keypoints` on the card and on the CPU for frame 0's keypoints
    (the port's front-end on the card) plus dots on the border, partly
    outside, wholly outside and invalid: torch.equal."""
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import SystemConfig
    from jetracer_orbslam2_torch.models.slam import Slam
    from jetracer_orbslam2_torch.ops.overlay import overlay_keypoints

    args = run.build_argparser().parse_args(["--dataset", root])
    src = run._open_source(args, dev)
    g, d, _, _ = run.to_device(src.load(0), dev)
    feats = Slam(SystemConfig(frontend=run._frontend_cfg(args, src.hw, src.cal)),
                 src.intr, device=dev).features(g, d)
    extra = torch.tensor([[0.0, 0.0], [639.0, 479.0], [639.5, 100.0],
                          [-0.5, 200.0], [300.0, -0.7], [640.0, 10.0],
                          [10.0, 480.0], [-5.0, -5.0], [320.0, 240.0]],
                         device=dev)
    xy = torch.cat([feats.xy, extra])
    valid = torch.cat([feats.valid, torch.tensor(
        [True] * 8 + [False], device=dev)])
    card = overlay_keypoints(g, xy, valid)
    cpu = overlay_keypoints(g.cpu(), xy.cpu(), valid.cpu())
    out = {"keypoints": int(valid.sum()), "equal": bool(torch.equal(card.cpu(), cpu)),
           "pixels_changed": int((cpu != g.cpu()).sum())}
    say("  overlay_keypoints, card vs CPU: " + json.dumps(out))
    if not out["equal"] or out["pixels_changed"] == 0:
        raise SystemExit("FAIL: overlay_keypoints differs between the card and the CPU")
    return out


def phase_runtime(dev) -> dict:
    """The CLI's `--mode slam` host loop behind the runtime, on a 640x480
    TUM-layout sequence written here: A (the loop without its runtime,
    driven by this phase), B (`--dataset`, through FramePipeline and the
    Watchdog), C (B + `--telemetry` with a client + `--checkpoint`), D
    (`--resume` from C's map), then B and A again; the gates of phase 20."""
    import os
    import shutil
    import statistics as st
    import tempfile
    import numpy as np
    from jetracer_orbslam2_torch.io import datasets
    from jetracer_orbslam2_torch.runtime.checkpoint import load_checkpoint

    tmp = tempfile.mkdtemp(prefix="jetracer_runtime_")
    try:
        root, ck = os.path.join(tmp, "seq"), os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        _write_tum_sequence(root, RUNTIME_FRAMES, dev)
        say(f"  wrote {RUNTIME_FRAMES} frames of 640x480 (RGB + 16-bit depth "
            f"PNGs, TUM layout) in {time.perf_counter() - t0:.2f} s")
        overlay = _overlay_card_vs_cpu(root, dev)
        runs, outs = {}, {}
        # the last two runs decode with PIL, which holds the GIL for part of
        # its work: do two workers then slow the host-bound loop?
        for name in ("A", "B", "C", "D", "B2", "A2", "B_pil", "A_pil"):
            argv = ["--dataset", root]
            client = None
            if name == "C":
                port = _free_port()
                argv += ["--telemetry", str(port), "--checkpoint", ck]
                client = _TelemetryClient(port)
            if name == "D":
                argv += ["--max-frames", str(RUNTIME_RESUME_FRAMES), "--resume", ck]
            before = dict(datasets.DECODED)
            pil = name.endswith("_pil")
            if pil:
                os.environ["JETRACER_DISABLE_NATIVE"] = "1"
            _reset_counters()
            try:
                with _RuntimeProbe(wait_for_client=client is not None) as probe:
                    if name.startswith("A"):
                        code, report = 0, _drive_without_pipeline(root, dev)
                    else:
                        code, report = _cli(argv)
            finally:
                if pil:
                    os.environ.pop("JETRACER_DISABLE_NATIVE")
            launches = _read_counters()
            frames = report.get("frames", 0)
            row = dict(report)
            row.update(
                exit=code, ms_per_frame=1e3 / report["fps"] if report.get("fps") else None,
                launches=launches, keyframes_inserted=probe.keyframe_updates,
                host_waits=dict(probe.waits),
                frame_waits_per_frame=probe.waits["frame"] / max(frames, 1),
                publish_waits_per_frame=probe.waits["publish"] / max(frames, 1),
                frames_pinned=probe.frames_pinned, frames_copied=probe.frames_copied,
                decode_ms_per_frame=(1e3 * sum(probe.decode_s) / len(probe.decode_s)
                                     if probe.decode_s else None),
                decoder={k: datasets.DECODED[k] - before[k] for k in before})
            if probe.jpeg_s:
                row.update(jpeg_ms_per_frame=1e3 * st.mean(probe.jpeg_s),
                           jpeg_bytes_per_frame=st.mean(probe.jpeg_bytes),
                           telemetry_bytes_per_frame=st.mean(probe.sent_bytes))
            if client is not None:
                client.thread.join(timeout=60)
                row.update(client_docs=len(client.docs), client_error=client.error)
                bad_docs = {i: b for i, doc in enumerate(client.docs)
                            if (b := _check_telemetry_doc(doc, 1024))}
                row["bad_docs"] = bad_docs
            runs[name] = row
            outs[name] = probe.result
            say(f"  run {name}: " + json.dumps(row))

        bad = []
        a, b, c, d = runs["A"], runs["B"], runs["C"], runs["D"]
        for name, r in runs.items():
            if r["exit"] != 0 or r.get("device") != "cuda:0":
                bad.append(f"{name}: exit {r['exit']} on {r.get('device')}")
            if r["launches"]["fast_nms_pyramid"] != r["frames"]:
                bad.append(f"{name}: K1 launches {r['launches']['fast_nms_pyramid']}")
            if r["launches"]["extract_patches_fused"] != r["frames"]:
                bad.append(f"{name}: K4 launches {r['launches']['extract_patches_fused']}")
            want_ba = 10 * r["keyframes_inserted"]
            if not (r["launches"]["fused_normal_schur"] == r["launches"]["fused_backsub"]
                    == want_ba):
                bad.append(f"{name}: K2/K3 launches {r['launches']} != {want_ba}")
            if short := _k5_k7_short(r["launches"], r["frames"] - 1):
                bad.append(f"{name}: {short}")
            if r["frames_pinned"] != r["frames_copied"] or r["frames_copied"] != r["frames"]:
                bad.append(f"{name}: {r['frames_pinned']} of {r['frames_copied']} "
                           "frames came pinned")
            if r["host_waits"]["worker"]:
                bad.append(f"{name}: a worker thread waited for the card")
            if "watchdog_stalls" in r and r["watchdog_stalls"] != 0:
                bad.append(f"{name}: {r['watchdog_stalls']} watchdog stalls")
            want = "pil" if name.endswith("_pil") else "native"
            if r["decoder"][want] <= 0 or sum(r["decoder"].values()) != r["decoder"][want]:
                bad.append(f"{name}: decoder {r['decoder']}, expected {want} only")
        for name in ("B", "C", "B2", "A2", "B_pil", "A_pil"):
            r = runs[name]
            for key in ("keyframes", "loops", "relocs", "tracked_frac", "ate_rmse_m",
                        "frames"):
                if r[key] != a[key]:
                    bad.append(f"{name} vs A: {key} {r[key]} != {a[key]}")
            if not (np.array_equal(outs[name].poses, outs["A"].poses)
                    and np.array_equal(outs[name].tracked, outs["A"].tracked)):
                bad.append(f"{name} vs A: poses or tracked flags differ")
            if name != "C" and r["host_waits"]["frame"] != a["host_waits"]["frame"]:
                bad.append(f"{name} vs A: host waits in the frames' calls "
                           f"{r['host_waits']['frame']} != {a['host_waits']['frame']}")
        if c["host_waits"]["frame"] != a["host_waits"]["frame"]:
            bad.append("C vs A: host waits outside the publish differ")
        if c["host_waits"]["publish"] > c["frames"]:
            bad.append(f"C: {c['host_waits']['publish']} host waits in "
                       f"{c['frames']} publishes (at most one a frame)")
        if not (a["ate_rmse_m"] < 0.10 and a["tracked_frac"] >= 0.95):
            bad.append(f"A: ATE {a['ate_rmse_m']} m, tracked {a['tracked_frac']}")
        if c.get("telemetry_sent", 0) + c.get("telemetry_dropped", 0) != c["frames"]:
            bad.append("C: telemetry sent + dropped != frames")
        if c.get("client_error") or c.get("client_docs", 0) < 2:
            bad.append(f"C: the client got {c.get('client_docs')} documents "
                       f"({c.get('client_error')})")
        if c.get("bad_docs"):
            bad.append(f"C: documents off: {c['bad_docs']}")
        saved, extra = load_checkpoint(ck)
        if int(saved.num_kf) != c["keyframes"] or extra != {"frames": c["frames"]}:
            bad.append(f"checkpoint: {int(saved.num_kf)} keyframes, {extra}")
        if d["frames"] != RUNTIME_RESUME_FRAMES or not d["keyframes"] >= c["keyframes"]:
            bad.append(f"D: {d['frames']} frames, keyframes {d['keyframes']} < "
                       f"{c['keyframes']}")
        if bad:
            raise SystemExit("FAIL: runtime phase: " + "; ".join(bad))
        summary = {
            "frames": RUNTIME_FRAMES,
            "ms_per_frame": {k: r["ms_per_frame"] for k, r in runs.items()},
            "decode_ms_per_frame": {k: r["decode_ms_per_frame"] for k, r in runs.items()},
            "host_waits_per_frame": {k: r["frame_waits_per_frame"]
                                     + r["publish_waits_per_frame"]
                                     for k, r in runs.items()},
            "jpeg_ms_per_frame": c["jpeg_ms_per_frame"],
            "telemetry_bytes_per_frame": c["telemetry_bytes_per_frame"],
            "decoder": {k: r["decoder"] for k, r in runs.items()},
            "overlay": overlay,
        }
        say("  runtime: " + json.dumps(summary))
        return {"runs": runs, "summary": summary}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 21: sharded BA and the mesh path
# ---------------------------------------------------------------------------

class _MeshRunProbe:
    """Patches, for one CLI run, what phase 21 reads off it: keyframe
    updates (`slam.keyframe_update`, which `Slam` and `slam_scan` call
    through the module) and the final poses and tracked flags
    (`Slam.result`, `ChunkedSlam.result` / `tracked`)."""

    def __enter__(self):
        from jetracer_orbslam2_torch.models import slam as slam_mod
        from jetracer_orbslam2_torch.models import slam_scan as ss

        self.keyframe_updates, self.poses, self.tracked = 0, None, None
        probe, self._saved = self, []

        def patch(owner, name, make):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, make(fn))

        def counted(fn):
            def wrapped(*a, **kw):
                probe.keyframe_updates += 1
                return fn(*a, **kw)
            return wrapped

        def slam_result(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                probe.poses, probe.tracked = out.poses, out.tracked
                return out
            return wrapped

        def captured(field):
            def make(fn):
                def wrapped(*a, **kw):
                    out = fn(*a, **kw)
                    setattr(probe, field, out)
                    return out
                return wrapped
            return make

        patch(slam_mod, "keyframe_update", counted)
        patch(slam_mod.Slam, "result", slam_result)
        patch(ss.ChunkedSlam, "result", captured("poses"))
        patch(ss.ChunkedSlam, "tracked", captured("tracked"))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def _sharded_solve(dev) -> tuple[dict, tuple]:
    """(a) `sharded_bundle_adjust` on a one-rank NCCL group against
    `bundle_adjust`, launches, host waits, and the timings."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
    from jetracer_orbslam2_torch.parallel import (
        make_mesh, prepare_sharded_problem, sharded_bundle_adjust)
    from jetracer_orbslam2_torch.parallel.bench_ba import (
        make_synthetic_ba, measure_scaling, time_ba, time_sharded_ba)

    mesh = make_mesh(1)
    say(f"  (a) {mesh!r}")
    if mesh.backend != "nccl" or mesh.device != dev or mesh.size != 1:
        raise SystemExit(f"FAIL: the one-rank mesh is {mesh!r}, not NCCL on {dev}")
    prob, intr = make_synthetic_ba(BA_POSES, BA_LANDMARKS, BA_OBS_PER_LM)
    cfg = BAConfig(iters=BA_ITERS)
    sprob = prepare_sharded_problem(prob, 1)
    sharded_bundle_adjust(sprob, intr, cfg, mesh)     # warm: the communicator
    torch.cuda.synchronize()
    _reset_ba_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses_s, points_s, trace_s = sharded_bundle_adjust(sprob, intr, cfg, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = _ba_counters()
    poses_u, points_u, stats = bundle_adjust(prob, intr, cfg)
    equal = (torch.equal(poses_s, poses_u) and torch.equal(points_s, points_u)
             and torch.equal(trace_s, stats.cost))
    trace = trace_s.cpu().numpy()
    say(f"  (a) sharded_bundle_adjust {BA_POSES} x {BA_LANDMARKS}, one rank: "
        f"trace {np.array2string(trace, precision=2)}; torch.equal to "
        f"bundle_adjust {equal}; K2/K3 launches {launches}; no host wait in "
        "the call (sync debug mode 'error')")
    if not equal:
        raise SystemExit("FAIL: the one-rank sharded solve differs from bundle_adjust")
    if launches != (BA_ITERS, BA_ITERS):
        raise SystemExit(f"FAIL: sharded K2/K3 launches {launches} != "
                         f"({BA_ITERS}, {BA_ITERS})")
    timing = {}
    for iters in (10, 50):
        c = BAConfig(iters=iters)
        runs = {"sharded": [], "unsharded": []}
        for kind in ("sharded", "unsharded", "unsharded", "sharded"):
            if kind == "sharded":
                runs[kind].append(time_sharded_ba(prob, intr, 1, c, reps=3))
            else:
                runs[kind].append(time_ba(prob, intr, c, reps=3))
        timing[iters] = {k: min(r["ms_per_iter"] for r in v) for k, v in runs.items()}
        say(f"  (a) iters {iters}: sharded (one rank) "
            f"{timing[iters]['sharded']:.3f} ms per LM iteration, unsharded "
            f"time_ba {timing[iters]['unsharded']:.3f} (warm, host clock, one "
            "fetch a run, best of 3, in turns s u u s)")
    mesh.close()
    rows = measure_scaling(n_poses=BA_POSES, n_landmarks=BA_LANDMARKS,
                           obs_per_lm=BA_OBS_PER_LM, iters=BA_ITERS)
    say(f"  (a) measure_scaling (a spawned group a mesh size, up to "
        f"{torch.cuda.device_count()} card(s)): {json.dumps(rows)}")
    if not rows or rows[0]["n"] != 1 or rows[0]["efficiency"] != 1.0:
        raise SystemExit(f"FAIL: measure_scaling gave {rows}")
    report = {
        "problem": [BA_POSES, BA_LANDMARKS, int(prob.obs_kf.shape[0])],
        "iters": BA_ITERS, "launches": list(launches), "equal_to_unsharded": equal,
        "cost_initial": float(trace[0]), "cost_final": float(trace[-1]),
        "ba_ms_per_iter_4096lm": timing[10]["sharded"],
        "ba_ms_per_iter_4096lm_amortized": timing[50]["sharded"],
        "time_ba_ms_per_iter": timing[10]["unsharded"],
        "time_ba_ms_per_iter_amortized": timing[50]["unsharded"],
        "measure_scaling": rows,
    }
    return report, (poses_s.cpu().numpy(), points_s.cpu().numpy())


def _sharded_local(m, intr, dev) -> dict:
    """(b) `sharded_local_ba` against `local_ba` on phase 9's full-capacity
    map (P 8, L 16,384)."""
    import torch
    from jetracer_orbslam2_torch.config import SystemConfig
    from jetracer_orbslam2_torch.models import slam
    from jetracer_orbslam2_torch.parallel import make_mesh, sharded_local_ba

    cfg = SystemConfig()
    W = cfg.map.window_size
    with make_mesh(1) as mesh:
        sharded_local_ba(m, intr, W, cfg, mesh)             # warm
        _reset_ba_counters()
        m2, dropped = sharded_local_ba(m, intr, W, cfg, mesh)
        launches = _ba_counters()
        m1 = slam.local_ba(m, intr, W, cfg)
        equal = all(torch.equal(a, b) for a, b in zip(m1, m2))
        n_dropped = int(dropped)

        def timed(fn) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        runs = {"sharded": [], "unsharded": []}
        for kind in ("sharded", "unsharded", "unsharded", "sharded",
                     "sharded", "unsharded"):
            runs[kind].append(timed(
                (lambda: sharded_local_ba(m, intr, W, cfg, mesh)) if kind == "sharded"
                else (lambda: slam.local_ba(m, intr, W, cfg))))
    ms = {k: min(v) for k, v in runs.items()}
    say(f"  (b) sharded_local_ba P {W}, L {m.lm_valid.shape[0]}: torch.equal to "
        f"local_ba {equal}, n_dropped {n_dropped}, K2/K3 launches {launches}; "
        f"{ms['sharded']:.2f} ms against local_ba {ms['unsharded']:.2f} ms (host "
        "clock around one call + sync, best of 3, in turns)")
    if not equal or n_dropped != 0:
        raise SystemExit("FAIL: sharded_local_ba differs from local_ba or dropped edges")
    if launches != (cfg.ba.iters, cfg.ba.iters):
        raise SystemExit(f"FAIL: sharded_local_ba launches {launches}")
    return {"problem": [W, int(m.lm_valid.shape[0]), int(m.obs_valid.shape[0])],
            "equal_to_local_ba": equal, "n_dropped": n_dropped,
            "launches": list(launches), "ms_sharded": ms["sharded"],
            "ms_local_ba": ms["unsharded"]}


def _mesh_cli(dev) -> tuple[dict, dict]:
    """(c) run.main at full width with --mesh 1 against the meshless run,
    whole and --chunked 8; returns (report, the --mesh 1 whole run's
    launches)."""
    import numpy as np
    import torch.distributed as dist

    if dist.is_initialized():
        raise SystemExit("FAIL: a process group is still up before (c)")
    out, bad = {}, []
    for extra in ([], ["--chunked", "8"]):
        runs = {}
        for mesh in ([], ["--mesh", "1"]):
            argv = ["--synthetic", str(N_FRAMES), "--mode", "slam"] + extra + mesh
            _reset_counters()
            with _MeshRunProbe() as probe:
                code, report = _cli(argv)
            report.update(exit=code, launches=_read_counters(),
                          keyframes_inserted=probe.keyframe_updates)
            runs["mesh" if mesh else "meshless"] = (report, probe.poses, probe.tracked)
            say(f"  (c) run.main({argv}) -> {code}: " + json.dumps(report))
        (rm, pm, tm), (r0, p0, t0) = runs["mesh"], runs["meshless"]
        name = "chunked8" if extra else "whole"
        if dist.is_initialized():
            bad.append(f"{name}: the CLI left its process group up")
        for what, r in (("mesh", rm), ("meshless", r0)):
            if r["exit"] != 0 or r.get("device") != "cuda:0":
                bad.append(f"{name} {what}: exit {r['exit']} on {r.get('device')}")
                continue
            if not (r["ate_rmse_m"] < 0.10 and r["tracked_frac"] >= 0.95):
                bad.append(f"{name} {what}: ATE {r['ate_rmse_m']} tracked "
                           f"{r['tracked_frac']}")
            k = r["launches"]
            if not (k["fast_nms_pyramid"] == k["extract_patches_fused"] == N_FRAMES):
                bad.append(f"{name} {what}: K1/K4 launches {k}")
            want = 10 * r["keyframes_inserted"]
            if not (k["fused_normal_schur"] == k["fused_backsub"] == want > 0):
                bad.append(f"{name} {what}: K2/K3 launches {k}, {want} expected")
            if short := _k5_k7_short(k, N_FRAMES - 1):
                bad.append(f"{name} {what}: {short}")
        if rm.get("mesh_devices") != 1 or rm.get("ba_edges_dropped") != 0:
            bad.append(f"{name}: mesh_devices {rm.get('mesh_devices')}, "
                       f"ba_edges_dropped {rm.get('ba_edges_dropped')}")
        for key in ("keyframes", "loops", "relocs", "landmarks", "ate_rmse_m"):
            if rm.get(key) != r0.get(key):
                bad.append(f"{name}: {key} {rm.get(key)} != {r0.get(key)}")
        if pm is None or p0 is None or not np.array_equal(pm, p0):
            bad.append(f"{name}: poses differ from the meshless run")
        if tm is None or t0 is None or not np.array_equal(tm, t0):
            bad.append(f"{name}: tracked flags differ from the meshless run")
        out[name] = {"mesh": rm, "meshless": r0,
                     "poses_equal": pm is not None and np.array_equal(pm, p0)}
    if bad:
        raise SystemExit("FAIL: the --mesh 1 CLI runs: " + "; ".join(bad))
    say("  (c) --mesh 1 whole and --chunked 8: keyframes, loops, relocs, poses "
        "and tracked flags equal to the meshless runs")
    return out, out["whole"]["mesh"]["launches"]


def _two_ranks(reference) -> dict:
    """(d) the worker twice on cuda:0 over gloo: 2,048 landmarks a rank."""
    import os
    import shutil
    import subprocess
    import tempfile
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="jetracer_two_ranks_")
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "jetracer_orbslam2_torch.parallel.distributed_worker",
             f"file://{os.path.join(tmp, 'store')}", "2", str(rank),
             "--device", "cuda:0", "--backend", "gloo",
             "--problem", f"{BA_POSES},{BA_LANDMARKS},{BA_OBS_PER_LM}",
             "--iters", str(BA_ITERS), "--time", "3",
             "--save", os.path.join(tmp, f"rank{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in (0, 1)]
        outs = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise SystemExit(f"FAIL: a rank of (d) exited {p.returncode}:\n"
                                     + e[-3000:])
                outs.append(json.loads(o.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        saved = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in (0, 1)]
        same = all(np.array_equal(saved[0][k], saved[1][k])
                   for k in ("poses", "points", "trace"))
        dp = float(np.abs(saved[0]["poses"] - reference[0]).max())
        dx = float(np.abs(saved[0]["points"] - reference[1]).max())
        tr = saved[0]["trace"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for o in outs:
        say(f"  (d) rank {o['rank']}: " + json.dumps(o))
    say(f"  (d) two ranks on one card over gloo: ranks bit-identical {same}, "
        f"against (a): poses {dp:.2e}, points {dx:.2e}; cost {tr[0]:.2f} -> "
        f"{tr[-1]:.2f}; {outs[0]['timing']['ms_per_iter']:.3f} ms per LM "
        "iteration (both ranks share one card: not a scaling figure)")
    bad = []
    if not same or outs[0]["digest"] != outs[1]["digest"]:
        bad.append("the ranks disagree")
    if dp >= 5e-3 or dx >= 2e-2:
        bad.append(f"off (a) by poses {dp}, points {dx}")
    if not tr[-1] < 0.2 * tr[0]:
        bad.append(f"cost {tr[-1]} >= 0.2 x {tr[0]}")
    for o in outs:
        k = o.get("launches", {})
        if o["world_size"] != 2 or o["backend"] != "gloo" or not (
                k.get("fused_normal_schur") == k.get("fused_backsub") == BA_ITERS):
            bad.append(f"rank {o['rank']}: world {o['world_size']} "
                       f"{o['backend']}, launches {k}")
    if bad:
        raise SystemExit("FAIL: two ranks: " + "; ".join(bad))
    return {"ranks_equal": same, "max_pose_diff_vs_a": dp,
            "max_point_diff_vs_a": dx, "cost_initial": float(tr[0]),
            "cost_final": float(tr[-1]),
            "ms_per_iter": outs[0]["timing"]["ms_per_iter"],
            "launches": [o["launches"] for o in outs]}


def phase_sharded(local_map, intr, dev) -> tuple[dict, dict]:
    """Phase 21: (a) the one-rank sharded solve, (b) the sharded local BA at
    full capacity, (c) the CLI with --mesh 1, (d) two ranks on the card."""
    solve, reference = _sharded_solve(dev)
    local = _sharded_local(local_map, intr, dev)
    cli, launches = _mesh_cli(dev)
    two = _two_ranks(reference)
    return {"solve": solve, "local_ba": local, "cli": cli, "two_ranks": two}, launches


# K5 against its plain version: rotation entries within K5_TOL, translations
# within K5_TOL of the points' scale (the plain version factors in f32 with
# cuSOLVER, the kernel in f64)
K5_TOL = 1e-5
K5_POINTS = 1024
# frames of phase 22's device-traced windows (a run in steady state)
BUSY = (40, 80)
# phase 22's forced tracking loss: frames of the arc, first and end of the
# blanked run
LOST = (60, 30, 34)


def _rotation(rng, angle_scale: float):
    """A random rotation (numpy f64) by Rodrigues' formula."""
    import numpy as np

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-angle_scale, angle_scale)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _rigid_problems(b: int, n: int, seed: int, dev, kinds=None):
    """b problems of n point pairs, dst = R src + t + 1 cm noise, 0/1 weights
    (70 % ones), from a numpy seed.  kinds[i]: "random", "zero" (all weights
    0), "coplanar" (src on a plane), "collinear" (src on a line)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    kinds = kinds or ["random"] * b
    src = rng.normal(0.0, 2.0, (b, n, 3)) + rng.normal(0.0, 3.0, (b, 1, 3))
    w = (rng.random((b, n)) < 0.7).astype(np.float32)
    dst = np.empty_like(src)
    for i, kind in enumerate(kinds):
        if kind == "coplanar":
            src[i, :, 2] = 4.0
        elif kind == "collinear":
            src[i] = src[i, :1] + np.outer(rng.normal(0.0, 2.0, n), [0.6, 0.0, 0.8])
        elif kind == "zero":
            w[i] = 0.0
        R, t = _rotation(rng, 1.0), rng.normal(0.0, 1.0, 3)
        dst[i] = src[i] @ R.T + t + rng.normal(0.0, 0.01, (n, 3))
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    return f(src), f(dst), f(w)


def _replayed(fn):
    """Two replays of `fn` captured into a CUDA graph (after a warm-up on
    the capture stream); returns both outputs (a tensor, or a tuple of
    them)."""
    import torch

    def copy(out):
        return tuple(x.clone() for x in out) if isinstance(out, tuple) else out.clone()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = copy(out)
    graph.replay()
    torch.cuda.synchronize()
    return first, copy(out)


def _same(a, b) -> bool:
    """torch.equal over a tensor or a tuple of tensors."""
    import torch

    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _pose_errors(got, plain, src, dst) -> tuple[float, float, float]:
    """(worst rotation entry, worst translation relative to the points'
    scale, that scale) of `got` against `plain`, (B, 4, 4) each."""
    scale = max(1.0, float(src.abs().max()), float(dst.abs().max()))
    err_r = float((got[:, :3, :3] - plain[:, :3, :3]).abs().max())
    err_t = float((got[:, :3, 3] - plain[:, :3, 3]).abs().max()) / scale
    return err_r, err_t, scale


def _refit_problems(b: int, n: int, seed: int, dev, kinds=None,
                    per_point_gate: bool = True):
    """`_rigid_problems` with a fifth of each dst moved by up to 0.5 m (the
    outliers the gate drops) and a gate: a point's own, 5 cm + 0.2 % z^2
    (ransac_kabsch's quadratic gate), or 5 cm for all (the map refit's)."""
    import numpy as np
    import torch

    src, dst, w = _rigid_problems(b, n, seed, dev, kinds)
    rng = np.random.default_rng(seed + 100)
    moved = (rng.random((b, n)) < 0.2)[..., None]
    shift = rng.uniform(-0.5, 0.5, (b, n, 3)) * moved
    dst = dst + torch.from_numpy(shift.astype(np.float32)).to(dev)
    gate = 0.05 + 0.002 * dst[..., 2] ** 2 if per_point_gate else 0.05
    return src, dst, w, gate


# the split of a K5 launch: csrc/rigid_fit.cu's own functions in two more
# kernels, built for phase 22 (a) only: the load and the reduction alone
# (writing the 16 moments), and the factorisation alone (one thread, the
# moments read from device memory, the pose written)
K5_SPLIT_SOURCE = r"""
#include "rigid_fit.cu"

namespace {

__global__ void __launch_bounds__(THREADS)
k5_reduce_only(const float* __restrict__ src, const float* __restrict__ dst,
               const float* __restrict__ weights, double* __restrict__ out, int n) {
    extern __shared__ __align__(16) float sm[];
    __shared__ double part[WARPS * NMOM];
    const long long b = blockIdx.x;
    const int n3 = 3 * n, off_d = round4(n3);
    float* ss = sm;
    float* sd = sm + off_d;
    float* sw = sm + 2 * off_d;
    stage(ss, src + b * n3, n3);
    stage(sd, dst + b * n3, n3);
    stage(sw, weights + b * n, n);
    commit_stage();
    wait_stage<0>();
    double v[NMOM];
    for (int k = 0; k < NMOM; ++k) v[k] = 0.0;
    for (int i = threadIdx.x; i < n; i += THREADS)
        accumulate(v, sw[i], ss + 3 * i, sd + 3 * i);
    reduce_moments(v, part);
    if (threadIdx.x != 0) return;
    double m[NMOM];
    totals(part, m);
    for (int k = 0; k < NMOM; ++k) out[b * NMOM + k] = m[k];
}

__global__ void __launch_bounds__(THREADS)
k5_factor_only(const double* __restrict__ moments, float* __restrict__ out) {
    if (threadIdx.x != 0) return;
    const long long b = blockIdx.x;
    double m[NMOM], R[3][3], t[3];
    for (int k = 0; k < NMOM; ++k) m[k] = moments[b * NMOM + k];
    solve(m, R, t);
    write_pose(out + b * 16, R, t);
}

}  // namespace

extern "C" int k5_reduce_launch(const float* src, const float* dst,
                                const float* w, double* out, int batch, int n,
                                void* stream) {
    k5_reduce_only<<<batch, THREADS, smem_bytes(n, 1),
                     static_cast<cudaStream_t>(stream)>>>(src, dst, w, out, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int k5_factor_launch(const double* moments, float* out, int batch,
                                void* stream) {
    k5_factor_only<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        moments, out);
    return static_cast<int>(cudaGetLastError());
}
"""


def _k5_split(src, dst, w) -> dict:
    """Device us a launch of K5's reduction alone, factorisation alone and
    both (rigid_fit itself), in turns, on these problems."""
    import ctypes
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_build.BUILD_DIR / "k5_split.cu"
    source.write_text(K5_SPLIT_SOURCE)
    lib_path = cuda_build.BUILD_DIR / "k5_split.so"
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(lib_path), str(source)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    reduce_fn, factor_fn = lib.k5_reduce_launch, lib.k5_factor_launch
    reduce_fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    factor_fn.argtypes = [ptr, ptr, i32, ptr]
    reduce_fn.restype = factor_fn.restype = i32
    b, n = src.shape[0], src.shape[1]
    moments = torch.empty((b, 16), dtype=torch.float64, device=src.device)
    pose = torch.empty((b, 4, 4), dtype=torch.float32, device=src.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def reduce_only():
        if reduce_fn(src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                     moments.data_ptr(), b, n, stream()) != 0:
            raise SystemExit("FAIL: K5's split reduction did not launch")

    def factor_only():
        if factor_fn(moments.data_ptr(), pose.data_ptr(), b, stream()) != 0:
            raise SystemExit("FAIL: K5's split factorisation did not launch")

    reduce_only()
    factor_only()
    full = fused_rigid.rigid_fit(src, dst, w)
    torch.cuda.synchronize()
    if not torch.equal(pose, full):
        raise SystemExit("FAIL: K5's split kernels disagree with rigid_fit")
    both = lambda: fused_rigid.rigid_fit(src, dst, w)  # noqa: E731
    times = {"reduction_us": [], "factorisation_us": [], "both_us": []}
    for _ in range(2):
        for key, fn in (("both_us", both), ("reduction_us", reduce_only),
                        ("factorisation_us", factor_only)):
            times[key].append(time_launches(fn, reps=20, batch=20) * 1e3)
    return times


def _k5_fit_cases(dev) -> tuple[list, float]:
    """rigid_fit against the SVD route: rows and the worst error."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid

    cases = [
        ("B 1, 0/1 weights", 1, None, False),
        ("B 1, no weights", 1, None, True),
        ("B 1, coplanar", 1, ["coplanar"], False),
        ("B 1, all weights 0", 1, ["zero"], False),
        ("B 8: 6 random, all weights 0, coplanar", 8,
         ["random"] * 6 + ["zero", "coplanar"], False),
    ]
    worst = 0.0
    rows = []
    for seed, (label, b, kinds, no_w) in enumerate(cases):
        src, dst, w = _rigid_problems(b, K5_POINTS, seed, dev, kinds)
        row = _check_fit(label, src, dst, None if no_w else w)
        got = row.pop("got")
        rows.append(row)
        worst = max(worst, row["rotation_err"], row["translation_err_rel"])
        if kinds and "zero" in kinds:
            i = kinds.index("zero")
            if not torch.equal(got[i], torch.eye(4, device=dev)):
                raise SystemExit(f"FAIL: K5 with all weights 0 gave {got[i]}")
    # collinear points: the rotation about the line is free, so no reference
    # transform exists; the kernel's must be proper and fit the points
    src, dst, w = _rigid_problems(1, K5_POINTS, 9, dev, ["collinear"])
    T = fused_rigid.rigid_fit(src, dst, w)[0].double()
    R = T[:3, :3]
    ortho = float((R @ R.T - torch.eye(3, dtype=R.dtype, device=dev)).abs().max())
    det = float(torch.linalg.det(R))
    fit_err = float(((src[0].double() @ R.T + T[:3, 3]) - dst[0].double())
                    .norm(dim=-1)[w[0] > 0].max())
    say(f"  K5 fit collinear points: |R R^T - I| {ortho:.2e}, det R {det:.9f}, "
        f"worst fit residual {fit_err * 100:.2f} cm (noise 1 cm)")
    if not (ortho <= K5_TOL and abs(det - 1.0) <= K5_TOL and fit_err < 0.06):
        raise SystemExit("FAIL: K5 on collinear points gave no proper fit")
    return rows, worst


def _check_fit(label: str, src, dst, w) -> dict:
    """rigid_fit against the SVD route on these problems: rotation entries
    and translations (of the points' scale) within K5_TOL, a relaunch and
    two graph replays torch.equal.  Returns the case's row."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid

    fit = lambda: fused_rigid.rigid_fit(src, dst, w)  # noqa: E731
    got, again = fit(), fit()
    plain = fused_rigid.rigid_fit_reference(src, dst, w)
    replays = _replayed(fit)
    torch.cuda.synchronize()
    err_r, err_t, scale = _pose_errors(got, plain, src, dst)
    bits = (torch.equal(got, again) and torch.equal(got, replays[0])
            and torch.equal(got, replays[1]))
    say(f"  K5 fit {label}: rotation {err_r:.2e}, translation {err_t:.2e} "
        f"of scale {scale:.1f} (tol {K5_TOL:g}); relaunch and two graph "
        f"replays torch.equal: {bits}")
    if not (err_r <= K5_TOL and err_t <= K5_TOL and bits):
        raise SystemExit(f"FAIL: K5 at {label}")
    return {"case": label, "points": src.shape[-2], "rotation_err": err_r,
            "translation_err_rel": err_t, "bit_identical": bits, "got": got}


def _check_refit(label: str, src, dst, w1, keep, gate) -> dict:
    """rigid_refit against its plain version (two SVD fits and the ops
    between them): T2 within K5_TOL, w2 and n equal but for points whose
    residual at the plain T1 lies within 1e-6 of the gate (relative),
    counted; relaunch and two graph replays torch.equal.  Returns the
    case's row."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid
    from jetracer_orbslam2_torch.ops.geometry import transform_points

    refit = lambda: fused_rigid.rigid_refit(  # noqa: E731
        src, dst, w1, keep, gate)
    got, again = refit(), refit()
    plain = fused_rigid.rigid_refit_reference(src, dst, w1, keep, gate)
    replays = _replayed(refit)
    torch.cuda.synchronize()
    err_r, err_t, scale = _pose_errors(got[0], plain[0], src, dst)
    # residuals at the plain route's first fit, against the gate
    T1 = fused_rigid.rigid_fit_reference(src, dst, w1)
    resid = torch.linalg.norm(transform_points(T1, src) - dst, dim=-1)
    g = gate if isinstance(gate, torch.Tensor) else torch.full_like(resid, gate)
    near = (resid - g).abs() <= 1e-6 * g
    differ = got[1] != plain[1]
    excused = int((differ & near).sum())
    unexcused = int((differ & ~near).sum())
    count_ok = (torch.equal(got[2], torch.count_nonzero(got[1], dim=-1).int())
                and (excused > 0 or torch.equal(got[2], plain[2])))
    bits = (_same(got, again) and _same(got, replays[0])
            and _same(got, replays[1]))
    n = src.shape[-2]
    say(f"  K5 refit {label}: rotation {err_r:.2e}, translation {err_t:.2e} "
        f"of scale {scale:.1f} (tol {K5_TOL:g}); w2 differs at {unexcused} "
        f"points, at {excused} within 1e-6 of the gate; n "
        f"{got[2].tolist()} (plain {plain[2].tolist()}) of {n}; "
        f"relaunch and two graph replays torch.equal: {bits}")
    if not (err_r <= K5_TOL and err_t <= K5_TOL and bits and count_ok
            and unexcused == 0):
        raise SystemExit(f"FAIL: K5 refit at {label}")
    return {"case": label, "points": n, "rotation_err": err_r,
            "translation_err_rel": err_t, "w2_differ_near_gate": excused,
            "w2_differ": unexcused, "kept": plain[2].tolist(),
            "bit_identical": bits}


def _k5_refit_cases(dev) -> tuple[list, float]:
    """`_check_refit` at B 1 and 8, N K5_POINTS; then the wrappers' checks
    on the card.  Returns rows and the worst error."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid

    cases = [
        ("B 1, a gate a point, keep 0/1", 1, None, True, False),
        ("B 1, one gate, keep = w x (0.5, 1]", 1, None, False, True),
        ("B 8: 6 random, all weights 0, coplanar; a gate a point", 8,
         ["random"] * 6 + ["zero", "coplanar"], True, False),
    ]
    worst = 0.0
    rows = []
    for seed, (label, b, kinds, per_point, scaled) in enumerate(cases, 20):
        src, dst, w1, gate = _refit_problems(b, K5_POINTS, seed, dev, kinds,
                                             per_point)
        keep = (w1 > 0).float()
        if scaled:
            rng = np.random.default_rng(seed)
            keep = w1 * torch.from_numpy(
                rng.uniform(0.5, 1.0, w1.shape).astype(np.float32)).to(dev)
        row = _check_refit(label, src, dst, w1, keep, gate)
        rows.append(row)
        worst = max(worst, row["rotation_err"], row["translation_err_rel"])
    # the wrappers' checks on the card: float32 only
    src, dst, w1, _ = _refit_problems(1, 8, 0, dev)
    refusals = [
        (TypeError, fused_rigid.rigid_refit,
         (src.double(), dst.double(), w1.double(), w1.double(), 0.05)),
        (TypeError, fused_rigid.rigid_refit, (src, dst, w1, w1.double(), 0.05)),
        (TypeError, fused_rigid.rigid_fit, (src.double(), dst.double())),
    ]
    refused = 0
    for err, entry, args in refusals:
        try:
            entry(*args)
        except err:
            refused += 1
    say(f"  K5 refuses float64 on the card: {refused} of {len(refusals)} "
        "calls refused")
    if refused != len(refusals):
        raise SystemExit("FAIL: K5 took an input its wrappers must refuse")
    return rows, worst


# K5 above its shared-memory path (fused_rigid.MAX_POINTS = 6,144): the first
# N past it (B 1), then N 8,192 and 16,384 at B 1 and 8 (the streamed path)
K5_LARGE = ((6145, (1,)), (8192, (1, 8)), (16384, (1, 8)))


def _k5_large(dev) -> tuple[list, list, float]:
    """rigid_fit and rigid_refit past MAX_POINTS, against the SVD route with
    phase 22 (a)'s bars; the us a launch at N 8,192 and 16,384 beside the
    bounds counted from the bytes.  Returns (check rows, time rows, the
    worst error)."""
    from jetracer_orbslam2_torch.ops import fused_rigid

    if K5_LARGE[0][0] != fused_rigid.MAX_POINTS + 1:
        raise SystemExit(f"FAIL: K5_LARGE starts at {K5_LARGE[0][0]}, not "
                         f"MAX_POINTS + 1 = {fused_rigid.MAX_POINTS + 1}")
    rows, times, worst = [], [], 0.0
    for n, batches in K5_LARGE:
        for b in batches:
            src, dst, w = _rigid_problems(b, n, 40 + b, dev)
            fit_row = _check_fit(f"B {b}, N {n}", src, dst, w)
            fit_row.pop("got")
            src, dst, w1, gate = _refit_problems(b, n, 50 + b, dev)
            keep = (w1 > 0).float()
            refit_row = _check_refit(f"B {b}, N {n}, a gate a point", src, dst,
                                     w1, keep, gate)
            rows += [fit_row, refit_row]
            worst = max(worst, fit_row["rotation_err"],
                        fit_row["translation_err_rel"],
                        refit_row["rotation_err"], refit_row["translation_err_rel"])
            if n == K5_LARGE[0][0]:
                continue
            fit = lambda: fused_rigid.rigid_fit(src, dst, w1)  # noqa: E731
            refit = lambda: fused_rigid.rigid_refit(  # noqa: E731
                src, dst, w1, keep, gate)
            row = {"points": n, "batch": b, "fit_us": [], "refit_us": []}
            for key, fn in (("fit_us", fit), ("refit_us", refit),
                            ("refit_us", refit), ("fit_us", fit)):
                row[key].append(time_launches(fn, reps=20, batch=20) * 1e3)
            for entry, is_refit in (("fit", False), ("refit", True)):
                bound, by, n_bytes, n_ops = _k5_bounds(b, is_refit, n)
                row[f"{entry}_bound_us"] = bound * 1e3
                row[f"{entry}_bound_by"] = by
                row[f"{entry}_bytes"], row[f"{entry}_ops"] = n_bytes, n_ops
            times.append(row)
            say(f"  K5 at B {b}, N {n} (streamed path; us a launch, in turns): "
                f"fit {row['fit_us'][0]:.2f} / {row['fit_us'][1]:.2f}, refit "
                f"{row['refit_us'][0]:.2f} / {row['refit_us'][1]:.2f}; bounds "
                f"fit {row['fit_bound_us']:.4f} ({row['fit_bound_by']}: "
                f"{row['fit_bytes']} B), refit {row['refit_bound_us']:.4f} "
                f"({row['refit_bound_by']}: {row['refit_bytes']} B)")
    return rows, times, worst


# run.main at a keypoint budget above MAX_POINTS: frames of each run
K5_CLI_FRAMES, K5_CLI_KEYPOINTS = 24, 8192


def _k5_cli_many_keypoints() -> list:
    """run.main --synthetic 24 --max-keypoints 8192 in odometry and slam
    mode: exit 0 on cuda:0, K5 launched at least once a tracked stepped
    frame, K6 once a stepped frame (odometry) or twice (slam), K7 once a
    stepped frame (odometry) or at least once (slam); the ATE is printed,
    not gated."""
    rows = []
    for mode in ("odometry", "slam"):
        argv = ["--synthetic", str(K5_CLI_FRAMES), "--max-keypoints",
                str(K5_CLI_KEYPOINTS), "--mode", mode]
        _reset_counters()
        code, report = _cli(argv)
        launches = _read_counters()
        frames = report.get("frames", 0)
        # tracked_frac counts frame 0, which bootstraps and is not stepped
        tracked = round(report.get("tracked_frac", 0.0) * frames) - 1
        per_frame = 1 if mode == "odometry" else 2
        row = {"argv": argv, "exit": code, "report": report,
               "launches": launches, "tracked_stepped_frames": tracked}
        rows.append(row)
        say(f"  K5 run.main({argv}) -> {code}: ATE {report.get('ate_rmse_m')} m "
            f"(printed, not gated), tracked {report.get('tracked_frac')}, "
            f"K5 {launches['rigid_fit']}, K6 {launches['pose_polish']}, K7 "
            f"{launches['ransac_select']} launches")
        bad = []
        if code != 0 or report.get("device") != "cuda:0" or frames != K5_CLI_FRAMES:
            bad.append(f"exit {code} on {report.get('device')}, {frames} frames")
        if launches["rigid_fit"] < max(tracked, 1):
            bad.append(f"K5 launched {launches['rigid_fit']} times for "
                       f"{tracked} tracked frames")
        if launches["pose_polish"] != per_frame * (frames - 1):
            bad.append(f"K6 launched {launches['pose_polish']} times, "
                       f"{per_frame * (frames - 1)} expected")
        # K7 (its streamed path above 6,144 pairs): one a stepped frame, and
        # in slam mode more where a loop is verified or a frame relocalized
        k7 = launches["ransac_select"]
        if k7 < frames - 1 or (mode == "odometry" and k7 != frames - 1):
            bad.append(f"K7 launched {k7} times for {frames - 1} stepped frames")
        if bad:
            raise SystemExit(f"FAIL: run.main --max-keypoints "
                             f"{K5_CLI_KEYPOINTS} --mode {mode}: {'; '.join(bad)}")
    return rows


def _k5_bounds(b: int, refit: bool, n: int = K5_POINTS) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, f32 operations) of one K5 launch of
    b problems of n pairs: each input read once, each output written
    once.  A fit reads src, dst, weights (28 B a point) and writes 64 B; per
    point 7 sums, 9 multiply-adds, 3 products; the 3 x 3 factorisation
    about 1,000 more.  The refit also reads keep and a gate a point and
    writes w2 and n (40 B a point); it does two fits and, per point, the
    residual at T1 (9 multiply-adds, 3 differences, a norm, the gate)."""
    per_fit = n * (7 + 18 + 3) + 1000
    if refit:
        n_bytes = b * (n * 40 + 64 + 4)
        n_ops = b * (2 * per_fit + n * (18 + 3 + 6 + 2))
    else:
        n_bytes = b * (n * 28 + 64)
        n_ops = b * per_fit
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, n_ops)


def _phase_k5(dev, floor_ms: float) -> dict:
    """(a) K5's two entries against their plain versions (the SVD route) on
    the card, relaunch and graph replay bit for bit, at N 1,024 and past the
    shared-memory path; run.main with 8,192 keypoints; the times of both
    entries at B 1 and 8 beside the two-call route (one graph), the plain
    routes and the bounds; the split of a fit."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_rigid
    from jetracer_orbslam2_torch.ops.geometry import transform_points

    fit_rows, fit_worst = _k5_fit_cases(dev)
    refit_rows, refit_worst = _k5_refit_cases(dev)
    large_rows, large_times, large_worst = _k5_large(dev)
    cli_rows = _k5_cli_many_keypoints()

    timed = {}
    for b in (1, 8):
        src, dst, w1, gate = _refit_problems(b, K5_POINTS, b, dev)
        keep = (w1 > 0).float()

        def two_calls():
            T1 = fused_rigid.rigid_fit(src, dst, w1)
            err = torch.linalg.norm(transform_points(T1, src) - dst, dim=-1)
            w2 = keep * (err < gate)
            return (fused_rigid.rigid_fit(src, dst, w2), w2,
                    torch.count_nonzero(w2, dim=-1).to(torch.int32))

        fit = lambda: fused_rigid.rigid_fit(src, dst, w1)  # noqa: E731
        refit = lambda: fused_rigid.rigid_refit(  # noqa: E731
            src, dst, w1, keep, gate)
        row = {"fit_us": [], "refit_us": [], "two_call_us": []}
        # in turns: fit, refit, two calls, two calls, refit, fit
        for key, fn in (("fit_us", fit), ("refit_us", refit),
                        ("two_call_us", two_calls), ("two_call_us", two_calls),
                        ("refit_us", refit), ("fit_us", fit)):
            row[key].append(time_launches(fn, reps=20, batch=20) * 1e3)
        # the plain routes wait on the host inside torch.linalg.svd, so they
        # cannot be captured: CUDA events around 10 eager calls, median of 10
        row["fit_plain_us"] = _median_event_ms(
            lambda: [fused_rigid.rigid_fit_reference(src, dst, w1)
                     for _ in range(10)], reps=10, per_run=10) * 1e3
        row["refit_plain_us"] = _median_event_ms(
            lambda: [fused_rigid.rigid_refit_reference(src, dst, w1, keep, gate)
                     for _ in range(10)], reps=10, per_run=10) * 1e3
        for entry, is_refit in (("fit", False), ("refit", True)):
            bound, by, n_bytes, n_ops = _k5_bounds(b, is_refit)
            row[f"{entry}_bound_us"] = bound * 1e3
            row[f"{entry}_bound_by"] = by
            row[f"{entry}_bytes"], row[f"{entry}_ops"] = n_bytes, n_ops
        timed[f"B {b}"] = row
        say(f"  K5 at B {b}, N {K5_POINTS} (us a launch, in turns): fit "
            f"{row['fit_us'][0]:.2f} / {row['fit_us'][1]:.2f}, refit "
            f"{row['refit_us'][0]:.2f} / {row['refit_us'][1]:.2f}, the two-call "
            f"route as one graph {row['two_call_us'][0]:.2f} / "
            f"{row['two_call_us'][1]:.2f}; floor {floor_ms * 1e3:.2f}; plain "
            f"routes (SVD, host waits) fit {row['fit_plain_us']:.1f}, refit "
            f"{row['refit_plain_us']:.1f} a call; bounds fit "
            f"{row['fit_bound_us']:.4f} ({row['fit_bound_by']}: "
            f"{row['fit_bytes']} B, {row['fit_ops']} f32 ops), refit "
            f"{row['refit_bound_us']:.4f} ({row['refit_bound_by']}: "
            f"{row['refit_bytes']} B, {row['refit_ops']} f32 ops)")

    src, dst, w = _rigid_problems(1, K5_POINTS, 0, dev)
    split = _k5_split(src, dst, w)
    say("  K5 split at B 1, N {} (us a launch, two turns): the load and "
        "reduction alone {}, the factorisation alone {}, both (rigid_fit) {}"
        .format(K5_POINTS, *(" / ".join(f"{x:.2f}" for x in split[k])
                             for k in ("reduction_us", "factorisation_us",
                                       "both_us"))))

    one = timed["B 1"]
    return {"cases": fit_rows, "refit_cases": refit_rows,
            "large_cases": large_rows, "large_times": large_times,
            "cli_many_keypoints": cli_rows,
            "max_err": max(fit_worst, refit_worst, large_worst),
            "ms": statistics.median(one["refit_us"]) / 1e3,
            "plain_ms": one["refit_plain_us"] / 1e3,
            "bound_ms": one["refit_bound_us"] / 1e3,
            "bound_by": one["refit_bound_by"],
            "fit_ms": statistics.median(one["fit_us"]) / 1e3,
            "fit_plain_ms": one["fit_plain_us"] / 1e3,
            "fit_bound_ms": one["fit_bound_us"] / 1e3,
            "two_call_ms": statistics.median(one["two_call_us"]) / 1e3,
            "times": timed, "split": split, "floor_ms": floor_ms,
            "library_ms": None}


def _count_waits(fn):
    """(fn(), host waits inside it) under sync-debug "warn"."""
    import warnings
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def _device_busy(fn) -> tuple:
    """(wall s, device-busy s, device kernels and copies) of one pass of `fn`
    traced on the device side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
    return wall, dev_s, sum(e.count for e in on_device)


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _graphed_window(gray, depth, intr, fcfg, tcfg, dev) -> tuple:
    """`_device_busy` of frames BUSY of a graphed odometry_scan in steady
    state: the graph captured and replayed on frames 1 to BUSY[0] - 1
    first."""
    from jetracer_orbslam2_torch.models import odometry as odo

    st = odo.init_state(gray[0], depth[0], intr, fcfg, tcfg, device=dev)
    st, _, _ = odo.odometry_scan(st, gray[1:BUSY[0]], depth[1:BUSY[0]], intr,
                                 fcfg, tcfg)
    return _device_busy(lambda: odo.odometry_scan(  # noqa: E731
        st, gray[BUSY[0]:BUSY[1]], depth[BUSY[0]:BUSY[1]], intr, fcfg, tcfg))


def _graph_odometry(gray, depth, intr, gt, fcfg, tcfg, dev) -> dict:
    """(b) the eager odometry_step with no host wait; (c) odometry_scan's
    graph against the eager step loop; (e) both timed in turns."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models import odometry as odo

    n = gray.shape[0]
    runs = {}

    def eager(sync_error: bool = False):
        st = odo.init_state(gray[0], depth[0], intr, fcfg, tcfg, device=dev)
        poses, oks = [st.T_wc], [torch.ones((), dtype=torch.bool, device=dev)]
        if sync_error:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(1, n):
                st, res = odo.odometry_step(st, gray[i], depth[i], intr, fcfg, tcfg)
                poses.append(res.T_wc)
                oks.append(res.tracked_ok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs["eager"] = (torch.stack(poses), torch.stack(oks))

    def graphed():
        st = odo.init_state(gray[0], depth[0], intr, fcfg, tcfg, device=dev)
        final, poses, oks = odo.odometry_scan(st, gray[1:], depth[1:], intr,
                                              fcfg, tcfg)
        runs["graphed"] = (torch.cat([st.T_wc[None], poses]),
                           torch.cat([oks.new_ones(1), oks]), final.graph)

    walls = {"eager": [_timed(eager)]}
    eager(sync_error=True)                       # (b): raises at a host wait
    ref = runs["eager"]
    _reset_counters()
    walls["graphed"] = [_timed(graphed)]
    launches = _read_counters()
    poses, oks, graph = runs["graphed"]
    walls["graphed"].append(_timed(graphed))
    walls["eager"].append(_timed(eager))
    same = (torch.equal(poses, ref[0]) and torch.equal(oks, ref[1])
            and torch.equal(runs["graphed"][0], poses)
            and torch.equal(runs["eager"][0], ref[0]))
    rmse = float(ate(poses.cpu(), torch.as_tensor(gt)).rmse)

    # the device-busy share over frames BUSY of a run in steady state
    st_e = odo.init_state(gray[0], depth[0], intr, fcfg, tcfg, device=dev)
    for i in range(1, BUSY[0]):
        st_e, _ = odo.odometry_step(st_e, gray[i], depth[i], intr, fcfg, tcfg)

    def eager_window():
        st = st_e
        for i in range(*BUSY):
            st, _ = odo.odometry_step(st, gray[i], depth[i], intr, fcfg, tcfg)

    busy = {"eager": _device_busy(eager_window),
            "graphed": _graphed_window(gray, depth, intr, fcfg, tcfg, dev)}
    window = BUSY[1] - BUSY[0]
    report = {
        "frames": n, "ate_rmse_m": rmse,
        "tracked_frac": float(oks.float().mean()),
        "graphed_equals_eager": same, "eager_host_waits": 0,
        "captures": graph.captures, "replays": graph.replays,
        "eager_calls": graph.eager_calls,
        "nodes": {fn.__name__: k for fn, k in graph.nodes.items()},
        "launches": launches,
        "ms_per_frame": {k: [w / (n - 1) * 1e3 for w in v]
                         for k, v in walls.items()},
        "device_busy_ms_per_frame": {k: b[1] / window * 1e3
                                     for k, b in busy.items()},
        "device_kernels_per_frame": {k: b[2] / window for k, b in busy.items()},
        "traced_ms_per_frame": {k: b[0] / window * 1e3 for k, b in busy.items()},
        "idle_share": {k: 1 - b[1] / b[0] for k, b in busy.items()},
        "turns": "eager, graphed, graphed, eager over every frame; then "
                 f"frames {BUSY[0]}-{BUSY[1] - 1} of each, traced on the device",
    }
    say("  odometry graph: " + json.dumps(report))
    if not same:
        diff = float((poses - ref[0]).abs().max())
        raise SystemExit(f"FAIL: the graphed odometry_scan differs from the "
                         f"eager step loop (max pose diff {diff:g})")
    if not (rmse < 0.10 and report["tracked_frac"] >= 0.95):
        raise SystemExit(f"FAIL: graphed odometry ATE {rmse} / tracked "
                         f"{report['tracked_frac']}")
    want = {"fast_nms_pyramid": n, "extract_patches_fused": n,
            "rigid_fit": n - 1, "pose_polish": n - 1, "ransac_select": n - 1}
    got = {k: launches[k] for k in want}
    if (graph.captures, graph.replays, graph.eager_calls) != (1, n - 2, 1) \
            or got != want:
        raise SystemExit(f"FAIL: odometry graph: captures {graph.captures}, "
                         f"replays {graph.replays}, eager calls "
                         f"{graph.eager_calls}, launches {got}; expected 1, "
                         f"{n - 2}, 1, {want}")
    return report


class _EagerStep:
    """`slam.tracking_step` called directly: the eager step a tracking
    graph is held against (the graph's call signature)."""

    def __init__(self, generator, cfg, extract=None):
        self.generator, self.cfg, self.extract = generator, cfg, extract

    def __call__(self, *args):
        from jetracer_orbslam2_torch.models import slam as slam_mod

        return slam_mod.tracking_step(self.generator, *args, cfg=self.cfg,
                                      extract=self.extract)


def _graph_slam(gray, depth, intr, gt, cfg, dev) -> dict:
    """(d) slam_scan and Slam graphed against their eager steps on the arc:
    poses, flags, keyframes, loops equal, one host wait a plain frame; (e)
    the scan timed in turns, and its device-busy share."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models import slam as slam_mod
    from jetracer_orbslam2_torch.models import slam_scan as ss

    n = gray.shape[0]
    waits = {"scan": [], "slam": []}
    step_fn, track_fn = ss._step, slam_mod.Slam._track

    def scan_step(*a, **kw):
        (state, row), k = _count_waits(lambda: step_fn(*a, **kw))
        waits["scan"].append((k, bool(row[3]) and not row[-1]))
        return state, row

    def slam_track(self, *a, **kw):
        report, k = _count_waits(lambda: track_fn(self, *a, **kw))
        # plain: tracked, and not a keyframe (whose uid is its frame id)
        waits["slam"].append((k, self.tracked[-1] and
                              self.frame_ref_uid[-1] != self.frame_idx - 1))
        return report

    def scan(eager: bool = False, upto: int = n, start=None, seq=None):
        """Frames 1..upto-1 from a fresh state, or frames BUSY from `start`;
        of the arc, or of `seq` (gray, depth)."""
        g, d = seq or (gray, depth)
        lo, hi = (1, upto) if start is None else BUSY
        state = start or ss.init_scan_state(g[0], d[0], intr, cfg, device=dev)
        if not eager:
            return ss.slam_scan(state, g[lo:hi], d[lo:hi], intr, cfg)
        step = _EagerStep(state.generator, cfg, ss.frame_extract(cfg, dev))
        rows = []
        for i in range(lo, hi):
            state, row = ss._step(state, g[i], d[i], (None, False),
                                  intr, cfg, None, step)
            rows.append(row)
        ref_uid, T_rel, T_w_emit, tracked, is_kf = zip(*rows)
        return state, ss.ScanOutput(
            ref_uid=torch.stack(ref_uid), T_rel=torch.stack(T_rel),
            T_w_emit=torch.stack(T_w_emit), tracked=torch.stack(tracked),
            is_kf=torch.tensor(is_kf, dtype=torch.bool, device=dev))

    def summary(final, out):
        poses = np.concatenate([final.m.kf_pose[:1].cpu().numpy(),
                                ss.compose_trajectory(final, out)])
        return {"poses": poses, "tracked": out.tracked.cpu().numpy(),
                "is_kf": out.is_kf.cpu().numpy(),
                "keyframes": int(final.m.num_kf), "loops": int(final.num_loops),
                "relocs": int(final.num_relocs)}

    class EagerSlam(slam_mod.Slam):
        def _graph(self, name, extract=None):
            return _EagerStep(self.generator, self.cfg, extract)

    def slam(eager: bool = False, seq=None):
        g, d = seq or (gray, depth)
        s = (EagerSlam if eager else slam_mod.Slam)(cfg, intr, device=dev)
        for i in range(g.shape[0]):
            s.process_frame(g[i], d[i])
        return s, s.result()

    def slam_equal(a, b) -> bool:
        return (np.array_equal(a.poses, b.poses)
                and np.array_equal(a.tracked, b.tracked)
                and (a.num_keyframes, a.num_loops, a.num_relocs)
                == (b.num_keyframes, b.num_loops, b.num_relocs))

    eager_scan = summary(*scan(eager=True))
    _reset_counters()
    ss._step, slam_mod.Slam._track = scan_step, slam_track
    try:
        final, out = scan()
        launches = _read_counters()
        graphed_scan = summary(final, out)
        graph = final.graph
        g_slam, g_out = slam()
    finally:
        ss._step, slam_mod.Slam._track = step_fn, track_fn
    _, e_out = slam(eager=True)
    same_scan = all(np.array_equal(graphed_scan[k], eager_scan[k])
                    for k in eager_scan)
    same_slam = slam_equal(g_out, e_out)
    # (d) again through a forced tracking loss: the frames LOST[1]..LOST[2]-1
    # of the arc's first LOST[0] are blank, so tracking fails, relocalization
    # draws eagerly between replays and re-poses the first frame after them
    lost_g = gray[:LOST[0]].clone()
    lost_g[LOST[1]:LOST[2]] = 0
    lost = (lost_g, depth[:LOST[0]])
    lost_scan = [summary(*scan(eager=e, upto=LOST[0], seq=lost))
                 for e in (False, True)]
    lost_slam = [slam(eager=e, seq=lost)[1] for e in (False, True)]
    reloc = {
        "frames": LOST[0], "blank": list(LOST[1:]),
        "relocs": {"scan": [r["relocs"] for r in lost_scan],
                   "slam": [o.num_relocs for o in lost_slam]},
        "scan_graphed_equals_eager": all(
            np.array_equal(lost_scan[0][k], lost_scan[1][k])
            for k in lost_scan[0]),
        "slam_graphed_equals_eager": slam_equal(*lost_slam),
    }
    # plain frames (tracked, no keyframe) after the capture (a run's first
    # tracked frame warms up, its second captures); a keyframe frame and a
    # relocalization wait more
    plain = {k: [w for w, is_plain in v[2:] if is_plain]
             for k, v in waits.items()}
    walls = {"eager": [_timed(lambda: scan(eager=True))]}
    walls["graphed"] = [_timed(scan), _timed(scan)]
    walls["eager"].append(_timed(lambda: scan(eager=True)))
    # the device-busy share over frames BUSY, after frames 1.. of a run
    st_g, _ = scan(upto=BUSY[0])
    st_e, _ = scan(eager=True, upto=BUSY[0])
    busy = {"eager": _device_busy(lambda: scan(eager=True, start=st_e)),
            "graphed": _device_busy(lambda: scan(start=st_g))}
    window = BUSY[1] - BUSY[0]
    frames = n - 1
    rmse = float(ate(torch.from_numpy(graphed_scan["poses"]),
                     torch.as_tensor(gt)).rmse)
    report = {
        "frames": n, "keyframes": graphed_scan["keyframes"],
        "loops": graphed_scan["loops"], "relocs": graphed_scan["relocs"],
        "ate_rmse_m": rmse,
        "tracked_frac": float(graphed_scan["tracked"].mean()),
        "scan_graphed_equals_eager": same_scan,
        "slam_graphed_equals_eager": same_slam,
        "captures": graph.captures, "replays": graph.replays,
        "eager_calls": graph.eager_calls,
        "launches": launches,
        "plain_frames": {k: len(v) for k, v in plain.items()},
        "host_waits_per_plain_frame": {
            k: (sum(v) / len(v) if v else None) for k, v in plain.items()},
        "host_waits_max_plain_frame": {k: max(v, default=None)
                                       for k, v in plain.items()},
        "ms_per_frame": {k: [w / frames * 1e3 for w in v]
                         for k, v in walls.items()},
        "device_busy_ms_per_frame": {k: b[1] / window * 1e3
                                     for k, b in busy.items()},
        "device_kernels_per_frame": {k: b[2] / window for k, b in busy.items()},
        "traced_ms_per_frame": {k: b[0] / window * 1e3 for k, b in busy.items()},
        "idle_share": {k: 1 - b[1] / b[0] for k, b in busy.items()},
        "turns": "eager, graphed, graphed, eager over every frame; then "
                 f"frames {BUSY[0]}-{BUSY[1] - 1} of each, traced on the device",
        "relocalization": reloc,
    }
    say("  SLAM graph: " + json.dumps(report))
    if not (same_scan and same_slam):
        raise SystemExit(f"FAIL: graphed SLAM differs from its eager step "
                         f"(slam_scan equal {same_scan}, Slam equal {same_slam})")
    if not (reloc["scan_graphed_equals_eager"]
            and reloc["slam_graphed_equals_eager"]):
        raise SystemExit(f"FAIL: through a tracking loss the graphed SLAM "
                         f"differs from its eager step: {reloc}")
    if min(reloc["relocs"]["scan"] + reloc["relocs"]["slam"]) < 1:
        raise SystemExit(f"FAIL: the forced tracking loss relocalized no "
                         f"frame: {reloc}")
    if not (rmse < 0.10 and report["tracked_frac"] >= 0.95):
        raise SystemExit(f"FAIL: graphed SLAM ATE {rmse} / tracked "
                         f"{report['tracked_frac']}")
    if (graph.captures, graph.replays, graph.eager_calls) != (1, n - 2, 1):
        raise SystemExit(f"FAIL: SLAM graph captures {graph.captures}, replays "
                         f"{graph.replays}, eager calls {graph.eager_calls}; "
                         f"expected 1, {n - 2}, 1")
    if launches["fast_nms_pyramid"] != n or launches["extract_patches_fused"] != n:
        raise SystemExit(f"FAIL: SLAM graph launches {launches}: K1 = K4 = {n} "
                         "expected")
    _without_k5_k7(launches, n - 1, "SLAM graph")
    if any(not v or max(v) != 1 or min(v) != 1 for v in plain.values()):
        raise SystemExit(f"FAIL: host waits of a plain SLAM frame: {plain} "
                         "(one expected: the packed fetch)")
    return report


def phase_graphs(source, args, dev, floor_ms: float) -> dict:
    """Phase 22: (a) K5; (b)-(e) the odometry and SLAM frame steps captured
    as CUDA graphs against their eager steps, on the CLI's arc."""
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import SystemConfig, TrackingConfig

    k5 = _phase_k5(dev, floor_ms)
    frames = list(source.frames())
    gray = torch.stack([f[0] for f in frames])
    depth = torch.stack([f[1] for f in frames])
    fcfg = run._frontend_cfg(args, source.hw, source.cal)
    odometry = _graph_odometry(gray, depth, source.intr, source.gt, fcfg,
                               TrackingConfig(), dev)
    slam = _graph_slam(gray, depth, source.intr, source.gt,
                       SystemConfig(frontend=fcfg), dev)
    return {"k5": k5, "odometry": odometry, "slam": slam}


# ---------------------------------------------------------------------------
# phase 23: K6, the reprojection polish as one kernel
# ---------------------------------------------------------------------------

# K6 against its plain version: rotation entries within K6_TOL, translations
# within K6_TOL of the points' scale (the plain version sums in f32 and
# solves by LU, the kernel sums in f32 a thread and a warp, then in f64, and
# solves by 3 x 3 blocks in f64)
K6_TOL = 1e-5
K6_ITERS, K6_HUBER = 5, 2.0         # the polish's defaults: 5 steps, 2 px
# fewer steps, where each step still moves T by far more than K6_TOL: a
# kernel that ran a step too few or in another order fails these
K6_SHORT_ITERS = (1, 2)
K6_POINTS = 1024
K6_CAPTURED_FRAMES = 40             # the odometry run's first frames
K6_CLUSTERS = (1, 2, 4, 8)          # the cluster sizes timed at K 1,024


def _polish_problems(b: int, k: int, seed: int, intr, dev, kind: str = "random"):
    """b polish problems of k points, from a numpy seed: points 0.8-8 m in
    front of the destination camera and inside its 640x480 image, seen from
    a source pose a small motion away (X_src); their pixels with 0.5 px
    noise, depths with 1 %.z^2 noise and a sixth of them missing; 0/1
    weights (70 % ones); T0 the true motion perturbed (RANSAC's estimate).
    kind: "random", "zero" (all weights 0), "no_depth" (every z_dst 0),
    "outliers" (a fifth of the pixels moved 10-50 px).  Returns (T0, X, uv,
    z, w) on `dev`, batched."""
    import numpy as np
    import torch

    fx, fy, cx, cy = (float(v) for v in intr.cpu())
    rng = np.random.default_rng(seed)
    T0 = np.zeros((b, 4, 4))
    X = np.empty((b, k, 3))
    uv = np.empty((b, k, 2))
    z = np.empty((b, k))
    for i in range(b):
        R, t = _rotation(rng, 0.03), rng.normal(0.0, 0.05, 3)
        depth = rng.uniform(0.8, 8.0, k)
        pix = np.stack([rng.uniform(0, 640, k), rng.uniform(0, 480, k)], -1)
        P = np.stack([(pix[:, 0] - cx) / fx * depth,
                      (pix[:, 1] - cy) / fy * depth, depth], -1)
        X[i] = (P - t) @ R                                 # R^T (P - t)
        uv[i] = pix + rng.normal(0.0, 0.5, (k, 2))
        z[i] = depth + rng.normal(0.0, 0.01, k) * depth ** 2
        z[i, rng.random(k) < 1 / 6] = 0.0
        dR, dt = _rotation(rng, 0.01), rng.normal(0.0, 0.02, 3)
        T0[i, :3, :3] = dR @ R
        T0[i, :3, 3] = dR @ t + dt
        T0[i, 3, 3] = 1.0
    w = (rng.random((b, k)) < 0.7).astype(np.float64)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "no_depth":
        z[:] = 0.0
    elif kind == "outliers":
        moved = rng.random((b, k)) < 0.2
        shift = rng.uniform(10.0, 50.0, (b, k, 2)) * rng.choice([-1.0, 1.0], (b, k, 2))
        uv[moved] += shift[moved]
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    return f(T0), f(X), f(uv), f(z), f(w)


def _check_polish(label: str, problem, intr, iters: int = K6_ITERS) -> dict:
    """pose_polish against pose_polish_reference on these problems, `iters`
    steps: rotation entries and translations (of the points' scale) within
    K6_TOL, a relaunch and two graph replays torch.equal, the steps whose
    H was not positive definite counted.  Returns the case's row (with
    "got")."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_polish

    T0, X, uv, z, w = problem
    singular = torch.zeros(T0.shape[:1], dtype=torch.int32, device=T0.device)
    polish = lambda: fused_polish.pose_polish(  # noqa: E731
        T0, X, uv, z, w, intr, iters, K6_HUBER)
    got = fused_polish.pose_polish(T0, X, uv, z, w, intr, iters, K6_HUBER,
                                   singular=singular)
    again = polish()
    plain = fused_polish.pose_polish_reference(T0, X, uv, z, w, intr, iters,
                                               K6_HUBER)
    replays = _replayed(polish)
    torch.cuda.synchronize()
    err_r, err_t, scale = _pose_errors(got, plain, X, X)
    bits = (torch.equal(got, again) and torch.equal(got, replays[0])
            and torch.equal(got, replays[1]))
    bad_steps = int(singular.sum())
    finite = bool(torch.isfinite(got).all())
    say(f"  K6 {label}: rotation {err_r:.2e}, translation {err_t:.2e} of scale "
        f"{scale:.1f} (tol {K6_TOL:g}); H not positive definite in "
        f"{bad_steps} of {T0.shape[0] * iters} steps; relaunch and two "
        f"graph replays torch.equal: {bits}")
    if not (err_r <= K6_TOL and err_t <= K6_TOL and bits and finite):
        raise SystemExit(f"FAIL: K6 at {label}")
    return {"case": label, "batch": T0.shape[0], "points": X.shape[1],
            "iters": iters, "rotation_err": err_r, "translation_err_rel": err_t,
            "singular_steps": bad_steps, "bit_identical": bits, "got": got}


def _k6_bounds(b: int, k: int) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, operations) of one K6 launch of b
    problems of k points: each input read once (T0 64 B, 28 B a point, the
    intrinsics 16 B), the output written once (64 B).  Per point and step:
    the transform (18), projection, residual, norm and Huber weight (about
    25), the Jacobian's nonzero entries (about 20), and the sums of H's 21
    upper entries and b's 6 over J's structural nonzeros (5, 5 and 3 in its
    three rows): 13 weight products and 36 + 13 multiply-adds, 111; 174 in
    all.  Per step the 6 x 6 solve and se3_exp, about 600."""
    n_bytes = b * (k * 28 + 64 + 64) + 16
    n_ops = b * K6_ITERS * (k * 174 + 600)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, n_ops)


def _captured_polish_problems(frames, intr, fcfg, dev):
    """The polish problems of the odometry run over `frames` (the eager
    `odometry_step` of phase 22's arc), stacked as one batch: (T0, X, uv,
    z, w)."""
    import torch
    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.models import odometry as odo
    from jetracer_orbslam2_torch.models import tracking

    tcfg = TrackingConfig()
    captured = []
    plain_call = tracking.refine_pose_reprojection

    def record(*a, **kw):
        if len(a) != 6 or kw:
            raise SystemExit(f"FAIL: track_rgbd's polish call changed: {len(a)} "
                             f"arguments, {sorted(kw)}")
        captured.append(tuple(x.clone() for x in a[:5]))
        return plain_call(*a, **kw)

    st = odo.init_state(frames[0][0], frames[0][1], intr, fcfg, tcfg, device=dev)
    tracking.refine_pose_reprojection = record
    try:
        for g, d, *_ in frames[1:]:
            st, _ = odo.odometry_step(st, g, d, intr, fcfg, tcfg)
    finally:
        tracking.refine_pose_reprojection = plain_call
    return tuple(torch.stack(x) for x in zip(*captured))


def _harness(name: str, text: str):
    """A harness that includes a kernel source of csrc/ (text), built by
    nvcc with the port's flags into the build directory and loaded."""
    import ctypes
    from jetracer_orbslam2_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = cuda_build.BUILD_DIR / f"{name}.cu"
    source.write_text(text)
    lib_path = cuda_build.BUILD_DIR / f"{name}.so"
    out = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(cuda_build.CSRC_DIR), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: nvcc on the {name} harness:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib_path))


# K6's paths at a shape the wrapper gives to one of them: the kernel of
# csrc/pose_polish.cu at a given cluster size (1, 2, 4, 8) and register room
# for a thread's points (0: read from memory on every step; 1; 8)
K6_PATHS_SOURCE = r"""
#include "pose_polish.cu"

extern "C" int k6_path_launch(const float* T0, const float* X, const float* uv,
                              const float* zd, const float* w, const float* intr,
                              float* out, int batch, int k, int iters, float huber,
                              int ctas, int per, void* stream) {
    if (ctas < 1 || ctas > MAX_CTAS || (ctas & (ctas - 1)) != 0 ||
        (per != 0 && per * ctas * THREADS < k))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (per == 0)
        err = launch<0>(T0, X, uv, zd, w, intr, out, nullptr, batch, k, iters, huber,
                        ctas, s);
    else if (per == 1)
        err = launch<1>(T0, X, uv, zd, w, intr, out, nullptr, batch, k, iters, huber,
                        ctas, s);
    else if (per == 8)
        err = launch<8>(T0, X, uv, zd, w, intr, out, nullptr, batch, k, iters, huber,
                        ctas, s);
    return static_cast<int>(err);
}
"""
# (K, register room) timed against pose_polish at that K, all at 8 blocks:
# room for one (the wrapper's at K 1,024), for 8 (the wrapper's up to 8,192)
# and none (the points read from memory each step)
K6_PATHS = ((1024, 1), (1024, 8), (1024, 0), (8192, 8), (8192, 0))


def _k6_paths(problems, intr) -> dict:
    """K6's paths through K6_PATHS_SOURCE on problems {K: (T0, X, uv, z,
    w)} (B 1), device us a launch: each (K, room) of K6_PATHS at 8 blocks
    against pose_polish at that K, in turns (pose_polish, the path, the
    path, pose_polish), each giving pose_polish's bits; then every cluster
    size of K6_CLUSTERS at K 1,024 (room for 8), each held to the plain
    version within K6_TOL and timed."""
    import ctypes
    import torch
    from jetracer_orbslam2_torch.ops import fused_polish

    fn = _harness("k6_paths", K6_PATHS_SOURCE).k6_path_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 7 + [i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    fn.restype = i32

    def forced(problem, ctas: int, per: int):
        T0, X, uv, z, w = problem
        out = torch.empty_like(T0)

        def run():
            if fn(*(x.data_ptr() for x in (T0, X, uv, z, w, intr, out)),
                  T0.shape[0], X.shape[1], K6_ITERS, K6_HUBER, ctas, per,
                  torch.cuda.current_stream().cuda_stream) != 0:
                raise SystemExit(f"FAIL: K6 at {ctas} block(s), room {per} did "
                                 "not launch")
            return out
        return run

    times = {"rooms": []}
    for k, per in K6_PATHS:
        problem = problems[k]
        wrapper = lambda: fused_polish.pose_polish(  # noqa: E731
            *problem, intr, K6_ITERS, K6_HUBER)
        path = forced(problem, max(K6_CLUSTERS), per)
        if not torch.equal(path(), wrapper()):
            raise SystemExit(f"FAIL: K6 at K {k}, room {per} differs from pose_polish")
        row = {"points": k, "room": per, "pose_polish_us": [], "path_us": []}
        for key, f in (("pose_polish_us", wrapper), ("path_us", path),
                       ("path_us", path), ("pose_polish_us", wrapper)):
            row[key].append(time_launches(f, reps=20, batch=20) * 1e3)
        times["rooms"].append(row)
    problem = problems[K6_POINTS]
    plain = fused_polish.pose_polish_reference(*problem, intr, K6_ITERS, K6_HUBER)
    times["clusters"] = {}
    for c in K6_CLUSTERS:
        run = forced(problem, c, 8)
        got = run()
        err_r, err_t, _ = _pose_errors(got, plain, problem[1], problem[1])
        bits = torch.equal(got, run())
        if not (err_r <= K6_TOL and err_t <= K6_TOL and bits):
            raise SystemExit(f"FAIL: K6 at {c} block(s): rotation {err_r:.2e}, "
                             f"translation {err_t:.2e}, relaunch equal {bits}")
        times["clusters"][c] = {
            "us": time_launches(run, reps=20, batch=20) * 1e3,
            "rotation_err": err_r, "translation_err_rel": err_t}
    return times


def phase_polish(source, args, dev, floor_ms: float) -> dict:
    """Phase 23: K6 against its plain version on synthetic problems and on
    the odometry run's own, at 5 steps and at 1 and 2; its time, the plain
    version's, the floor and the bound, its register path against its
    streamed path; the graphed odometry frame's nodes and busy ms with K6
    and with the plain version, in turns."""
    import itertools
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.models import tracking
    from jetracer_orbslam2_torch.ops import fused_polish

    intr = source.intr
    cases = [
        ("B 1, K 1,024", 1, K6_POINTS, "random"),
        ("B 8, K 1,024", 8, K6_POINTS, "random"),
        ("B 1, K 8,192 (8 blocks, 8 points a thread)", 1, 8192, "random"),
        ("B 1, all weights 0", 1, K6_POINTS, "zero"),
        ("B 1, no depth rows", 1, K6_POINTS, "no_depth"),
        ("B 1, 20 % outliers", 1, K6_POINTS, "outliers"),
        # the cluster sizes the wrapper takes for K up to 512
        ("B 1, K 128 (1 block, no cluster)", 1, 128, "random"),
        ("B 1, K 256 (2 blocks)", 1, 256, "random"),
        ("B 1, K 512 (4 blocks)", 1, 512, "random"),
    ]
    rows, problems = [], {}
    for seed, (label, b, k, kind) in enumerate(cases, 60):
        problem = _polish_problems(b, k, seed, intr, dev, kind)
        problems[label] = problem
        row = _check_polish(label, problem, intr)
        got = row.pop("got")
        if kind == "zero" and not torch.equal(got, problem[0]):
            raise SystemExit("FAIL: K6 with all weights 0 did not return T0")
        rows.append(row)
    frames = list(itertools.islice(source.frames(), BUSY[1]))
    fcfg = run._frontend_cfg(args, source.hw, source.cal)
    real = _captured_polish_problems(frames[:K6_CAPTURED_FRAMES], intr, fcfg, dev)
    real_label = (f"the first {K6_CAPTURED_FRAMES} frames' problems of the "
                  f"odometry run as one batch (B {real[0].shape[0]}, K "
                  f"{real[1].shape[1]})")
    row = _check_polish(real_label, real, intr)
    got = row.pop("got")
    alone = torch.stack([fused_polish.pose_polish(
        *(x[i] for x in real), intr, K6_ITERS, K6_HUBER)
        for i in range(real[0].shape[0])])
    row["rows_equal_alone"] = torch.equal(alone, got)
    if not row["rows_equal_alone"]:
        raise SystemExit("FAIL: K6's batch rows differ from one launch a problem")
    rows.append(row)
    for iters in K6_SHORT_ITERS:
        for label, problem in ((cases[0][0], problems[cases[0][0]]),
                               (real_label, real)):
            row = _check_polish(f"{label}, {iters} step(s)", problem, intr, iters)
            row.pop("got")
            rows.append(row)
    worst = max(max(r["rotation_err"], r["translation_err_rel"]) for r in rows)
    say(f"  K6: worst error {worst:.2e} (tol {K6_TOL:g}); non-positive "
        f"leading minors of H in {sum(r['singular_steps'] for r in rows)} steps "
        "over every case; each batch row equal to its problem alone")

    times = {}
    for label in cases[0][0], cases[1][0], cases[2][0]:
        T0, X, uv, z, w = problems[label]
        kernel = lambda: fused_polish.pose_polish(  # noqa: E731
            T0, X, uv, z, w, intr, K6_ITERS, K6_HUBER)
        plain = lambda: [fused_polish.pose_polish_reference(  # noqa: E731
            T0, X, uv, z, w, intr, K6_ITERS, K6_HUBER) for _ in range(10)]
        row = {"us": [], "plain_us": []}
        # in turns: kernel, plain, plain, kernel
        for key, fn in (("us", kernel), ("plain_us", plain), ("plain_us", plain),
                        ("us", kernel)):
            if key == "us":
                row[key].append(time_launches(fn, reps=20, batch=20) * 1e3)
            else:
                row[key].append(_median_event_ms(fn, reps=10, per_run=10) * 1e3)
        bound, by, n_bytes, n_ops = _k6_bounds(T0.shape[0], X.shape[1])
        row.update(bound_us=bound * 1e3, bound_by=by, bytes=n_bytes, ops=n_ops,
                   floor_us=floor_ms * 1e3)
        times[label] = row
        say(f"  K6 at {label} (us a launch, in turns): {row['us'][0]:.2f} / "
            f"{row['us'][1]:.2f}; the plain version {row['plain_us'][0]:.1f} / "
            f"{row['plain_us'][1]:.1f} a call (CUDA events around 10 eager "
            f"calls); floor {floor_ms * 1e3:.2f}; bound {row['bound_us']:.4f} "
            f"({by}: {n_bytes} B, {n_ops} ops)")

    # the split of a launch at B 1, K 1,024: no step (the launch, the load,
    # the write), one step, five; then the same launch with the points read
    # from memory on every step
    one = times[cases[0][0]]
    T0, X, uv, z, w = problems[cases[0][0]]
    steps = {}
    for iters in (0, 1, K6_ITERS):
        steps[iters] = time_launches(lambda: fused_polish.pose_polish(  # noqa: E731
            T0, X, uv, z, w, intr, iters, K6_HUBER), reps=20, batch=20) * 1e3
    one["steps_us"] = steps
    say(f"  K6 split at {cases[0][0]} (us a launch): 0 steps {steps[0]:.2f}, "
        f"1 step {steps[1]:.2f}, {K6_ITERS} steps {steps[K6_ITERS]:.2f}")
    one["paths"] = _k6_paths({K6_POINTS: problems[cases[0][0]],
                              8192: problems[cases[2][0]]}, intr)
    paths = one["paths"]
    for row in paths["rooms"]:
        what = (f"room for {row['room']} point(s) a thread" if row["room"]
                else "the points read from memory each step")
        say(f"  K6 at B 1, K {row['points']}, 8 blocks: pose_polish against "
            f"{what} (us a launch, in turns, the same bits): "
            f"{' / '.join(f'{v:.2f}' for v in row['pose_polish_us'])} against "
            f"{' / '.join(f'{v:.2f}' for v in row['path_us'])}")
    say("  K6 cluster sizes forced at K 1,024, room for 8 (each within tol of "
        "the plain version): "
        + ", ".join(f"{c} block(s) {v['us']:.2f} us (rotation "
                    f"{v['rotation_err']:.1e}, translation "
                    f"{v['translation_err_rel']:.1e})"
                    for c, v in paths["clusters"].items()))

    # the graphed odometry frame over frames BUSY, with K6 and with the plain
    # version in its place, in turns
    gray = torch.stack([f[0] for f in frames])
    depth = torch.stack([f[1] for f in frames])
    tcfg = TrackingConfig()
    kernel_call = tracking.refine_pose_reprojection
    frame = {"kernel": [], "plain": []}
    for key in ("kernel", "plain", "plain", "kernel"):
        if key == "plain":
            tracking.refine_pose_reprojection = fused_polish.pose_polish_reference
        try:
            frame[key].append(_graphed_window(gray, depth, intr, fcfg, tcfg, dev))
        finally:
            tracking.refine_pose_reprojection = kernel_call
    window = BUSY[1] - BUSY[0]
    odometry_frame = {
        k: {"device_kernels_per_frame": [b[2] / window for b in v],
            "device_busy_ms_per_frame": [b[1] / window * 1e3 for b in v]}
        for k, v in frame.items()}
    say(f"  graphed odometry frame (frames {BUSY[0]}-{BUSY[1] - 1}, in turns): "
        "with K6 " + ", ".join(
            f"{n:.1f} device kernels and copies, busy {ms:.3f} ms"
            for n, ms in zip(*odometry_frame["kernel"].values()))
        + "; with the plain polish " + ", ".join(
            f"{n:.1f}, busy {ms:.3f} ms"
            for n, ms in zip(*odometry_frame["plain"].values())))
    return {"cases": rows, "max_err": worst, "times": times,
            "ms": statistics.median(one["us"]) / 1e3,
            "plain_ms": statistics.median(one["plain_us"]) / 1e3,
            "bound_ms": one["bound_us"] / 1e3, "bound_by": one["bound_by"],
            "floor_ms": floor_ms, "library_ms": None,
            "odometry_frame": odometry_frame}


# ---------------------------------------------------------------------------
# phase 24: K7, RANSAC's hypotheses, scores and winner as one kernel
# ---------------------------------------------------------------------------

K7_ITERS = 256                      # TrackingConfig.ransac_iters
K7_VERIFY_ITERS = 512               # a loop verification's draws
K7_POINTS = 1024
K7_NEAR = 1e-6                      # "near the gate": |err - tz| <= K7_NEAR tz
K7_CLUSTERS = (1, 2, 4, 8, 16)      # the cluster sizes timed at H 256
# f32 operations a (hypothesis, point) test (the transform 3 x 7, the
# squared norm 5, the compare 1; a multiply-add counts 2) and a hypothesis'
# solve (centroids and centring 36, the correlation 45, K and K^2 130, the
# trace powers 70, 30 Newton steps of 15, the 16 cofactors and their norms
# 270, q, R and t 60)
K7_TEST_OPS, K7_SOLVE_OPS = 27, 1061


def _ransac_problems(b: int, k: int, h: int, seed: int, dev, kind: str = "random",
                     thresh: float = 0.05, depth_quad: float = 0.0,
                     gate_cap: float = 1e9):
    """b RANSAC problems of k pairs and h draws, from a numpy seed: src the
    points of a 640x480 frame 0.8-8 m ahead, dst = R src + t + 5 mm noise
    with 30 % of the pairs moved up to 0.5 m, 0/1 weights (75 % ones), h
    triples drawn with replacement from the weighted pairs (as
    torch.multinomial draws them), the gate thresh + depth_quad z_dst^2
    capped at gate_cap.  kind: "random"; "zero" (all weights 0, the draws
    uniform); "degenerate" (a third of the triples one index three times,
    a third two of one index, the rest collinear points); "collinear"
    (every src on one line).  Returns (src, dst, keep, sample_idx, tz) on
    `dev`, batched."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src = np.empty((b, k, 3))
    dst = np.empty((b, k, 3))
    w = (rng.random((b, k)) < 0.75).astype(np.float64)
    idx = np.empty((b, h, 3), dtype=np.int64)
    for i in range(b):
        depth = rng.uniform(0.8, 8.0, k)
        px = rng.uniform(-0.6, 0.6, (k, 2))
        src[i] = np.stack([px[:, 0] * depth, px[:, 1] * depth, depth], -1)
        if kind == "collinear":
            src[i] = src[i, :1] + np.outer(rng.normal(0.0, 2.0, k), [0.6, 0.0, 0.8])
        R, t = _rotation(rng, 0.1), rng.normal(0.0, 0.1, 3)
        dst[i] = src[i] @ R.T + t + rng.normal(0.0, 0.005, (k, 3))
        moved = rng.random(k) < 0.3
        dst[i, moved] += rng.uniform(-0.5, 0.5, (int(moved.sum()), 3))
        if kind == "zero":
            w[i] = 0.0
        p = np.maximum(w[i], 1e-20)
        idx[i] = rng.choice(k, size=(h, 3), p=p / p.sum())
        if kind == "degenerate":
            third = h // 3
            idx[i, :third] = idx[i, :third, :1]
            idx[i, third:2 * third, 1] = idx[i, third:2 * third, 0]
            # the rest: three pairs whose src lie on one line
            line = src[i, idx[i, 2 * third:, 0]]
            step = rng.normal(0.0, 0.5, (h - 2 * third, 2, 1)) * [0.6, 0.0, 0.8]
            for m in (1, 2):
                j = idx[i, 2 * third:, m]
                src[i, j] = line + step[:, m - 1]
                dst[i, j] = src[i, j] @ R.T + t
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    dst_t = f(dst)
    tz = torch.clamp_max(thresh + depth_quad * dst_t[..., 2] ** 2, gate_cap)
    return f(src), dst_t, f(w), torch.from_numpy(idx).to(dev), tz


def _plain_inliers(problem):
    """The plain version's (B, H, K) inlier matrix and each entry's distance
    from its gate relative to the gate, from the plain kabsch_quat."""
    import torch
    from jetracer_orbslam2_torch.ops import geometry as geo

    src, dst, keep, idx, tz = problem
    inl, margin = [], []
    for i in range(src.shape[0]):
        T_h = geo.kabsch_quat(src[i][idx[i]], dst[i][idx[i]])
        src_t = src[i][None] @ T_h[:, :3, :3].transpose(-1, -2) + T_h[:, None, :3, 3]
        err = torch.linalg.norm(src_t - dst[i][None], dim=-1)
        inl.append((err < tz[i][None]) & (keep[i] > 0))
        margin.append((err - tz[i][None]).abs() / tz[i][None])
    return torch.stack(inl), torch.stack(margin)


def _check_ransac(label: str, problem) -> dict:
    """ransac_select against ransac_select_reference on these problems: the
    winner and w1 equal, but for points within K7_NEAR of their gate
    (relative, at the plain version's hypotheses), which are counted; where
    such a point moves the winner, the plain score of K7's winner must be
    the plain best; the score the count of w1; a relaunch and two graph
    replays torch.equal.  Returns the case's row (with "got")."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_ransac

    select = lambda: fused_ransac.ransac_select(*problem)  # noqa: E731
    got, again = select(), select()
    plain = fused_ransac.ransac_select_reference(*problem)
    replays = _replayed(select)
    torch.cuda.synchronize()
    inl, margin = _plain_inliers(problem)
    keep = problem[2] > 0
    near = (margin <= K7_NEAR) & keep[:, None, :]
    near_total = int(near.sum())
    rows = torch.arange(inl.shape[0], device=inl.device)
    scores = inl.sum(-1)
    winner_same = bool(torch.equal(got[0], plain[0]))
    winner_ok = winner_same or (
        near_total > 0 and torch.equal(scores[rows, got[0]], scores[rows, plain[0]]))
    # w1 against the plain mask of K7's own winner
    mask = inl[rows, got[0]].float()
    differ = got[2] != mask
    near_w = near[rows, got[0]]
    excused = int((differ & near_w).sum())
    unexcused = int((differ & ~near_w).sum())
    count_ok = torch.equal(got[1], got[2].sum(-1).int())
    bits = (_same(got, again) and _same(got, replays[0]) and _same(got, replays[1]))
    moved = int((got[0] != plain[0]).sum())
    # the largest difference from the plain outputs: w1 against the plain
    # w1 (0 or 1 a point, excused points included), 1 where a winner moved
    max_err = max(float((got[2] - plain[2]).abs().max()), float(moved > 0))
    say(f"  K7 {label}: winner equal in {inl.shape[0] - moved} of {inl.shape[0]} "
        f"problem(s) (scores {got[1].tolist()[:8]}, plain "
        f"{plain[1].tolist()[:8]}); w1 differs at {unexcused} points, at "
        f"{excused} within {K7_NEAR:g} of the gate; {near_total} (hypothesis, "
        f"point) pairs within {K7_NEAR:g} of the gate; relaunch and two graph "
        f"replays torch.equal: {bits}")
    if not (winner_ok and unexcused == 0 and count_ok and bits):
        raise SystemExit(f"FAIL: K7 at {label}")
    return {"case": label, "batch": inl.shape[0], "hypotheses": inl.shape[1],
            "points": inl.shape[2], "winners_moved": moved,
            "w1_differ": unexcused, "w1_differ_near_gate": excused,
            "near_gate_pairs": near_total, "max_err": max_err,
            "scores": got[1].tolist(), "bit_identical": bits, "got": got}


def _k7_bounds(b: int, h: int, k: int) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, operations) of one K7 launch of b
    problems of k pairs and h draws: each input read once (src and dst 24 B
    a pair, keep and tz 8 B, the draws 24 B a hypothesis), each output
    written once (w1 4 B a pair, the winner 8 B and its count 4 B); per
    (hypothesis, pair) K7_TEST_OPS, per pair the gate's square and its two
    bounds (3), per hypothesis K7_SOLVE_OPS (its 30 Newton steps, as the
    plain version runs them)."""
    n_bytes = b * (k * 36 + h * 24 + 12)
    n_ops = b * (h * k * K7_TEST_OPS + 3 * k + h * K7_SOLVE_OPS)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, n_ops)


@contextlib.contextmanager
def _ransac_select_as(fn):
    """`tracking.ransac_kabsch` calling `fn` in place of
    `fused_ransac.ransac_select` (the wrapper itself, which counts its
    launches on its own name, stays as it is)."""
    import types
    from jetracer_orbslam2_torch.models import tracking

    module = tracking.fused_ransac
    tracking.fused_ransac = types.SimpleNamespace(ransac_select=fn)
    try:
        yield
    finally:
        tracking.fused_ransac = module


def _captured_ransac_problems(frames, intr, fcfg, dev):
    """The RANSAC problems of the odometry run over `frames` (the eager
    `odometry_step` of phase 22's arc, its draws as drawn), stacked as one
    batch: (src, dst, keep, sample_idx, tz)."""
    import torch
    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.models import odometry as odo
    from jetracer_orbslam2_torch.ops import fused_ransac

    tcfg = TrackingConfig()
    captured = []

    def record(*a, **kw):
        if len(a) != 5 or kw:
            raise SystemExit(f"FAIL: ransac_kabsch's K7 call changed: {len(a)} "
                             f"arguments, {sorted(kw)}")
        captured.append(tuple(x.clone() for x in a))
        return fused_ransac.ransac_select(*a)

    st = odo.init_state(frames[0][0], frames[0][1], intr, fcfg, tcfg, device=dev)
    with _ransac_select_as(record):
        for g, d, *_ in frames[1:]:
            st, _ = odo.odometry_step(st, g, d, intr, fcfg, tcfg)
    return tuple(torch.stack(x) for x in zip(*captured))


# K7's other paths at a shape the wrapper gives to its own: the kernel of
# csrc/ransac_hyp.cu at a given cluster size (1-16), the points staged in
# shared memory or read from memory
K7_PATHS_SOURCE = r"""
#include "ransac_hyp.cu"

extern "C" int k7_path_launch(const float* src, const float* dst, const float* keep,
                              const long long* idx, const float* tz, long long* best,
                              int* score, float* w1, int batch, int k, int h, int ctas,
                              int staged, void* stream) {
    if (ctas < 1 || ctas > MAX_CTAS || (staged && k > MAX_STAGED))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        staged ? launch<true>(src, dst, keep, idx, tz, best, score, w1, batch, k, h, ctas, s)
               : launch<false>(src, dst, keep, idx, tz, best, score, w1, batch, k, h, ctas, s);
    return static_cast<int>(err);
}
"""


def _k7_paths(problem) -> dict:
    """K7's paths at this problem (B 1, H 256, K 1,024), through
    K7_PATHS_SOURCE, device us a launch: every cluster size of K7_CLUSTERS
    with the points staged, then the wrapper's cluster size with the points
    read from memory; each must give ransac_select's outputs."""
    import ctypes
    import torch
    from jetracer_orbslam2_torch.ops import fused_ransac

    lib = _harness("k7_paths", K7_PATHS_SOURCE)
    if lib.ransac_hyp_setup() != 0:
        raise SystemExit("FAIL: the K7 harness's setup failed")
    fn = lib.k7_path_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    fn.restype = i32
    src, dst, keep, idx, tz = problem
    b, k, h = src.shape[0], src.shape[1], idx.shape[1]

    def forced(ctas: int, staged: bool):
        best = torch.empty((b,), dtype=torch.int64, device=src.device)
        score = torch.empty((b,), dtype=torch.int32, device=src.device)
        w1 = torch.empty((b, k), dtype=torch.float32, device=src.device)

        def run():
            if fn(*(x.data_ptr() for x in (src, dst, keep, idx, tz, best, score, w1)),
                  b, k, h, ctas, int(staged),
                  torch.cuda.current_stream().cuda_stream) != 0:
                raise SystemExit(f"FAIL: K7 at {ctas} block(s) did not launch")
            return best, score, w1
        return run

    want = fused_ransac.ransac_select(*problem)
    times = {"clusters_us": {}}
    for ctas in K7_CLUSTERS:
        run = forced(ctas, True)
        if not _same(run(), want):
            raise SystemExit(f"FAIL: K7 with {ctas} block(s) differs")
        times["clusters_us"][ctas] = time_launches(run, reps=20, batch=20) * 1e3
    run = forced(max(K7_CLUSTERS), False)
    if not _same(run(), want):
        raise SystemExit("FAIL: K7's staged and streamed paths differ")
    times["streamed_us"] = time_launches(run, reps=20, batch=20) * 1e3
    return times


def phase_ransac(source, args, dev, floor_ms: float) -> dict:
    """Phase 24: K7 against its plain version on synthetic problems and on
    the odometry run's own; its time beside the plain version's, the floor
    and the bound, the cluster sizes and the streamed path; the graphed
    odometry frame's nodes and busy ms with K7 and with the plain version,
    in turns."""
    import itertools
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.ops import fused_ransac

    cases = [
        (f"B 1, H {K7_ITERS}, K {K7_POINTS}", 1, K7_POINTS, K7_ITERS, "random", {}),
        (f"B 1, H {K7_VERIFY_ITERS}, K {K7_POINTS}", 1, K7_POINTS, K7_VERIFY_ITERS,
         "random", {}),
        (f"B 1, H {K7_ITERS}, K 8,192 (streamed)", 1, 8192, K7_ITERS, "random", {}),
        ("B 1, all weights 0", 1, K7_POINTS, K7_ITERS, "zero", {}),
        ("B 1, degenerate draws (repeated indices, collinear triples)", 1,
         K7_POINTS, K7_ITERS, "degenerate", {}),
        ("B 1, collinear points", 1, K7_POINTS, K7_ITERS, "collinear", {}),
        ("B 1, all scores equal (a 1e6 m gate)", 1, K7_POINTS, K7_ITERS, "random",
         {"thresh": 1e6}),
        ("B 1, depth_quad 0.02, gate_cap 0.15", 1, K7_POINTS, K7_ITERS, "random",
         {"depth_quad": 0.02, "gate_cap": 0.15}),
        (f"B 8, H {K7_ITERS}, K {K7_POINTS}", 8, K7_POINTS, K7_ITERS, "random", {}),
    ]
    rows, problems = [], {}
    for seed, (label, b, k, h, kind, gate) in enumerate(cases, 80):
        problem = _ransac_problems(b, k, h, seed, dev, kind, **gate)
        problems[label] = problem
        row = _check_ransac(label, problem)
        got = row.pop("got")
        if (kind == "zero" or "scores equal" in label) and bool((got[0] != 0).any()):
            raise SystemExit(f"FAIL: K7 at {label}: the winner is not 0")
        if b > 1:
            alone = [fused_ransac.ransac_select(*(x[i] for x in problem))
                     for i in range(b)]
            row["rows_equal_alone"] = all(
                _same(tuple(x[i] for x in got), one) for i, one in enumerate(alone))
            if not row["rows_equal_alone"]:
                raise SystemExit("FAIL: K7's batch rows differ from one launch a problem")
        rows.append(row)
    frames = list(itertools.islice(source.frames(), BUSY[1]))
    fcfg = run._frontend_cfg(args, source.hw, source.cal)
    real = _captured_ransac_problems(frames[:K6_CAPTURED_FRAMES], source.intr,
                                     fcfg, dev)
    real_label = (f"the first {K6_CAPTURED_FRAMES} frames' problems of the "
                  f"odometry run as one batch (B {real[0].shape[0]}, H "
                  f"{real[3].shape[1]}, K {real[0].shape[1]})")
    row = _check_ransac(real_label, real)
    got = row.pop("got")
    alone = [fused_ransac.ransac_select(*(x[i] for x in real))
             for i in range(real[0].shape[0])]
    row["rows_equal_alone"] = all(
        _same(tuple(x[i] for x in got), one) for i, one in enumerate(alone))
    if not row["rows_equal_alone"]:
        raise SystemExit("FAIL: K7's batch rows differ from one launch a problem")
    rows.append(row)
    near = sum(r["w1_differ_near_gate"] for r in rows)
    say(f"  K7: winners moved in {sum(r['winners_moved'] for r in rows)} "
        f"problems, w1 points within {K7_NEAR:g} of the gate that differ: "
        f"{near}; each batch row equal to its problem alone")

    times = {}
    for label in cases[0][0], cases[1][0], cases[2][0], cases[-1][0]:
        problem = problems[label]
        kernel = lambda: fused_ransac.ransac_select(*problem)  # noqa: E731
        plain = lambda: [fused_ransac.ransac_select_reference(  # noqa: E731
            *problem) for _ in range(10)]
        row = {"us": [], "plain_us": []}
        for key, fn in (("us", kernel), ("plain_us", plain), ("plain_us", plain),
                        ("us", kernel)):
            if key == "us":
                row[key].append(time_launches(fn, reps=20, batch=20) * 1e3)
            else:
                row[key].append(_median_event_ms(fn, reps=10, per_run=10) * 1e3)
        b, k, h = problem[0].shape[0], problem[0].shape[1], problem[3].shape[1]
        bound, by, n_bytes, n_ops = _k7_bounds(b, h, k)
        row.update(bound_us=bound * 1e3, bound_by=by, bytes=n_bytes, ops=n_ops,
                   floor_us=floor_ms * 1e3)
        times[label] = row
        say(f"  K7 at {label} (us a launch, in turns): {row['us'][0]:.2f} / "
            f"{row['us'][1]:.2f}; the plain version {row['plain_us'][0]:.1f} / "
            f"{row['plain_us'][1]:.1f} a call (CUDA events around 10 eager "
            f"calls); floor {floor_ms * 1e3:.2f}; bound {row['bound_us']:.4f} "
            f"({by}: {n_bytes} B, {n_ops} ops)")
    # the cluster sizes and the streamed path at the main path's shape: the
    # same outputs whatever the split
    one = times[cases[0][0]]
    one.update(_k7_paths(problems[cases[0][0]]))
    say(f"  K7 at {cases[0][0]}, cluster sizes forced (the same outputs): "
        + ", ".join(f"{c} block(s) {v:.2f} us" for c, v in one["clusters_us"].items())
        + f"; the points read from memory {one['streamed_us']:.2f} us")

    # the graphed odometry frame over frames BUSY, with K7 and with the plain
    # version in its place, in turns
    gray = torch.stack([f[0] for f in frames])
    depth = torch.stack([f[1] for f in frames])
    tcfg = TrackingConfig()
    frame = {"kernel": [], "plain": []}
    for key in ("kernel", "plain", "plain", "kernel"):
        select = (fused_ransac.ransac_select if key == "kernel"
                  else fused_ransac.ransac_select_reference)
        with _ransac_select_as(select):
            frame[key].append(_graphed_window(gray, depth, source.intr, fcfg, tcfg,
                                              dev))
    window = BUSY[1] - BUSY[0]
    odometry_frame = {
        k: {"device_kernels_per_frame": [b[2] / window for b in v],
            "device_busy_ms_per_frame": [b[1] / window * 1e3 for b in v]}
        for k, v in frame.items()}
    say(f"  graphed odometry frame (frames {BUSY[0]}-{BUSY[1] - 1}, in turns): "
        "with K7 " + ", ".join(
            f"{n:.1f} device kernels and copies, busy {ms:.3f} ms"
            for n, ms in zip(*odometry_frame["kernel"].values()))
        + "; with the plain RANSAC " + ", ".join(
            f"{n:.1f}, busy {ms:.3f} ms"
            for n, ms in zip(*odometry_frame["plain"].values())))
    worst = {"winners_moved": sum(r["winners_moved"] for r in rows),
             "w1_differ_near_gate": near}
    return {"cases": rows, "worst": worst, "times": times,
            "max_err": max(r["max_err"] for r in rows),
            "ms": statistics.median(one["us"]) / 1e3,
            "plain_ms": statistics.median(one["plain_us"]) / 1e3,
            "bound_ms": one["bound_us"] / 1e3, "bound_by": one["bound_by"],
            "floor_ms": floor_ms, "library_ms": None,
            "odometry_frame": odometry_frame}


def print_build(name: str) -> None:
    from jetracer_orbslam2_torch.utils import cuda_build

    info = cuda_build.build_info[name]
    say(f"  nvcc built csrc/{name}.cu in {info['seconds']:.2f} s -> "
        f"{cuda_build.library_path(name).name}")
    for line in info["log"].splitlines():
        say("    " + line)


def main(argv: list[str]) -> int:
    t_start = time.perf_counter()
    if argv not in ([], ["--kernels"]):
        print("usage: python3 chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
    # --kernels: build, check and time the kernels only (phases 1-3, 6, 7, 11, 16)
    kernels_only = argv == ["--kernels"]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port under test; absent in a directory that holds only this script
    import jetracer_orbslam2_torch
    from jetracer_orbslam2_torch.ops import (
        fused_ba, fused_fast, fused_patches, fused_polish, fused_ransac,
        fused_rigid)
    from jetracer_orbslam2_torch.utils import cuda_build
    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    phase = lambda k, text: say(  # noqa: E731
        f"[{k}/{N_PHASES}] {text}  (at {time.perf_counter() - t_start:.1f} s)")
    phase(1, "device")
    card = card_line()
    say(card)
    dev = resolve_device(None)
    set_exact_f32()
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, port {jetracer_orbslam2_torch.__version__}")

    phase(2, "build (one nvcc per source, started together)")
    t0 = time.perf_counter()
    sources = ["fast_nms", "ba_fused", "patch_gather", "rigid_fit", "pose_polish",
               "ransac_hyp"]
    cuda_build.build_libraries(sources)
    fused_fast._launcher()
    fused_ba._launchers()
    fused_patches._library()
    fused_rigid._launchers()
    fused_polish._launcher()
    fused_ransac._launcher()
    say(f"  six libraries built and loaded in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        print_build(name)

    with torch.no_grad():
        phase(3, "fast_nms and patch kernels vs their plain versions "
                 "(torch.equal)")
        argv_run, args, source, levels = open_source(N_FRAMES, dev)
        max_err, all_equal = phase_kernel_checks(levels)
        patch_max_err, patch_all_equal, (patch_pyramid, patch_kp) = (
            phase_patch_kernel_checks(dev))

        if not kernels_only:
            phase(4, "device semantics")
            phase_semantics(dev)

            phase(5, f"main path: {N_FRAMES} frames of 640x480, 4 levels, K=1024")
            report, launches, poses = phase_main_path(argv_run, args, source, dev)

        phase(6, "fast_nms times: one launch a frame vs the old schedule, and per "
                 "level (CUDA events around a replayed CUDA graph of 20 calls, "
                 "median of 20; the image is L2-warm, as the front-end leaves it)")
        floor_ms = launch_floor_ms()
        say(f"  launch floor: an empty kernel (one block of one thread) "
            f"{floor_ms * 1e3:.3f} us a launch through the same harness")
        times = phase_kernel_times(levels, floor_ms)
        times["stereo"] = phase_k1_stereo_batch(dev, floor_ms)

        phase(7, "fused_normal_schur (K2) and fused_backsub (K3) vs their plain "
                 "versions; errors relative to each output's scale, against the "
                 f"plain version in float64; tol = {TOL_FACTOR:g} x plain err + "
                 f"{TOL_FLOOR:g}")
        worst = phase_ba_kernel_checks(dev)

        if not kernels_only:
            phase(8, f"BA path: bundle_adjust, {BA_POSES} poses x {BA_LANDMARKS} "
                     f"landmarks, {BA_ITERS} LM iterations")
            ba_report = phase_ba_path(dev)

            phase(9, f"local BA: {KF_COUNT} keyframes (every {KF_EVERY}th frame) "
                     "in a map of full capacity")
            local_report, local_map = phase_local_ba(args, source, poses, dev)

            phase(10, "pose graph")
            pg_report = phase_pose_graph(dev)

        phase(11, "K2/K3 times (CUDA events around a replayed CUDA graph of 20 "
                  "launches, median of 20; inputs L2-warm, as the LM loop leaves "
                  "them)")
        ba_times = phase_ba_kernel_times(dev, floor_ms)
        if kernels_only:
            phase(16, "K4 time (CUDA events around a replayed CUDA graph of 20 "
                      "launches, median of 20; the levels are L2-warm, as the "
                      "pyramid leaves them)")
            patch_time = phase_patch_kernel_time(patch_pyramid, patch_kp, floor_ms)
            say(card)
            say(json.dumps({"fast_nms_pyramid": times, "ba_kernels": ba_times,
                            "patches": patch_time, "floor_ms": floor_ms,
                            "fast_nms_max_abs_err": max_err, "ba_worst": worst,
                            "patch_max_abs_err": patch_max_err, "card": card}))
            return 0

        phase(12, f"SLAM lap: {LAP_FRAMES} frames of {LAP_SHAPE[1]}x{LAP_SHAPE[0]}, "
                  f"one lap of {LAP_LENGTH}, depth noise {LAP_NOISE:g} z^2; "
                  "slam_scan and Slam")
        lap_report = phase_slam_lap(dev)

        phase(13, f"SLAM path: slam_scan over {LONG_FRAMES} frames of 640x480, "
                  f"laps of {LONG_LAP}, 4 levels, K=1024, two-threshold FAST, "
                  f"depth noise {LONG_NOISE:g} z^2")
        slam_report, slam_launches = phase_slam_path(dev)

        phase(14, "map lifecycle: three laps through 32 keyframe slots")
        lifecycle_report = phase_map_lifecycle(dev)

        phase(15, "CLI: python -m jetracer_orbslam2_torch.run --synthetic 60 --json")
        cli_reports = phase_cli()

        phase(16, "K4 time (CUDA events around a replayed CUDA graph of 20 "
                  "launches, median of 20; the levels are L2-warm, as the "
                  "pyramid leaves them)")
        patch_time = phase_patch_kernel_time(patch_pyramid, patch_kp, floor_ms)

        phase(17, "stereo check: frontend_stereo on a 640x480 pair, card vs CPU")
        stereo_check = phase_stereo_check(dev)

        phase(18, f"stereo path: slam_scan over {STEREO_FRAMES} stereo pairs of "
                  f"640x480 (arc, and a lap of {STEREO_LAP}), 4 levels, K=1024, "
                  f"two-threshold FAST, baseline {STEREO_BASELINE} m")
        stereo_report = phase_stereo_path(dev)
        stereo_launches = {k: sum(r["launches"][k] for r in stereo_report.values())
                           for k in _kernel_counters()}

        phase(19, "datasets: run.main --dataset on every fixture, on the card")
        datasets_report = phase_datasets()

        phase(20, f"runtime: the --mode slam host loop through FramePipeline, "
                  f"telemetry and checkpoint/resume, {RUNTIME_FRAMES} frames of "
                  "640x480")
        runtime_report = phase_runtime(dev)
        runtime_launches = runtime_report["runs"]["C"]["launches"]

        phase(21, "sharded BA and the mesh path: (a) sharded_bundle_adjust on a "
                  "one-rank NCCL group, (b) sharded_local_ba at full capacity, "
                  f"(c) run.main --mesh 1 ({N_FRAMES} frames of 640x480, whole "
                  "and --chunked 8), (d) two ranks on this card over gloo")
        sharded_report, sharded_launches = phase_sharded(local_map, source.intr, dev)

        phase(22, GRAPHS_TITLE)
        graphs = phase_graphs(source, args, dev, floor_ms)

        phase(23, "K6 (pose_polish) vs its plain version, its time (CUDA "
                  "events around a replayed CUDA graph of 20 launches, median "
                  "of 20), the graphed odometry frame's nodes")
        polish = phase_polish(source, args, dev, floor_ms)

        phase(24, "K7 (ransac_select) vs its plain version, its time (CUDA "
                  "events around a replayed CUDA graph of 20 launches, median "
                  "of 20), the graphed odometry frame's nodes")
        ransac = phase_ransac(source, args, dev, floor_ms)
    torch.cuda.synchronize()

    k1 = times["odometry"]
    kernels = [{
        "name": "fast_nms_pyramid",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/fast_nms.cu",
        "replaces": "jetracer_orbslam2_tpu/ops/pallas_fast.py:190",
        "launches": runtime_launches["fast_nms_pyramid"],
        "stereo_path_launches": stereo_launches["fast_nms_pyramid"],
        "sharded_path_launches": sharded_launches["fast_nms_pyramid"],
        "odometry_launches": launches,
        "max_abs_err": max_err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "exact_match": all_equal,
        "numbers_are": "per launch = per frame: the 4 levels of 640x480 at one "
                       "threshold (the odometry path's configuration); launches "
                       "are the runtime path's (phase 20 run C, one a frame), "
                       "stereo_path_launches the stereo path's (one a frame: "
                       "both pyramids in one launch), sharded_path_launches "
                       "the --mesh 1 CLI run's (phase 21c), odometry_launches the "
                       "odometry path's; "
                       "'slam' is the time at the SLAM path's two thresholds, "
                       "with its launches; 'stereo' a stereo frame's two "
                       "pyramids by one launch each and by one launch, timed "
                       "in the same run; "
                       "old_schedule_ms is the same work as one launch per level "
                       "and threshold, timed in the same run",
        "old_schedule_ms": k1["old_schedule_ms"],
        "slam": {**times["slam"], "launches": slam_launches["fast_nms_pyramid"]},
        "stereo": times["stereo"],
        "odometry": k1,
        "shapes": times["shapes"],
    }]
    for key, name, line, count in (
            ("K2", "fused_normal_schur", 290, ba_report["launches"][0]),
            ("K3", "fused_backsub", 321, ba_report["launches"][1])):
        at_path = ba_times[name][0]          # (8, 4096): the BA path's shape
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "jetracer_orbslam2_torch/csrc/ba_fused.cu",
            "replaces": f"jetracer_orbslam2_tpu/ops/pallas_ba.py:{line}",
            "launches": runtime_launches[name],
            "stereo_path_launches": stereo_launches[name],
            "sharded_path_launches": sharded_launches[name],
            "sharded_ba_launches": sharded_report["solve"]["launches"][0 if key == "K2" else 1],
            "two_ranks_launches": [r[name] for r in sharded_report["two_ranks"]["launches"]],
            "ba_path_launches": count,
            "max_abs_err": worst[key]["abs"],
            "max_abs_err_scale": worst[key]["scale"],
            "max_abs_err_where": worst[key]["where"],
            "ms": at_path["ms"],
            "plain_ms": at_path["plain_ms"],
            "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"],
            "library_ms": None,
            "floor_ms": at_path["floor_ms"],
            "numbers_are": "per launch at (P 8, L 4096), the BA path's shape; "
                           "launches are the runtime path's (phase 20 run C), "
                           "stereo_path_launches the stereo path's, "
                           "sharded_path_launches the --mesh 1 CLI run's "
                           "(phase 21c, on each rank's block), "
                           "sharded_ba_launches phase 21a's one-rank solve's, "
                           "two_ranks_launches phase 21d's per rank, "
                           "ba_path_launches "
                           "the BA path's (local BA launched "
                           f"{local_report['launches']} more); floor_ms is an "
                           "empty kernel's launch through the same harness",
            "shapes": ba_times[name],
        })
    kernels.append({
        "name": "extract_patches_fused",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/patch_gather.cu",
        "replaces": "scripts/experiment_pallas_patches.py:52",
        "launches": runtime_launches["extract_patches_fused"],
        "stereo_path_launches": stereo_launches["extract_patches_fused"],
        "sharded_path_launches": sharded_launches["extract_patches_fused"],
        "slam_path_launches": slam_launches["extract_patches_fused"],
        "max_abs_err": patch_max_err,
        "exact_match": patch_all_equal,
        "ms": patch_time["ms"],
        "plain_ms": patch_time["plain_ms"],
        "bound_ms": patch_time["bound_ms"],
        "bound_by": patch_time["bound_by"],
        "library_ms": patch_time["library_ms"],
        "pr4_route_ms": patch_time["pr4_route_ms"],
        "pr4_route_launches": slam_launches["patch_gather"],
        "canvas_kernel_ms": patch_time["canvas_kernel_ms"],
        "floor_ms": patch_time["floor_ms"],
        "numbers_are": "per launch = per frame on frame 0's 640x480 pyramid (4 "
                       "levels), K 1024, P 37, read from the levels; launches "
                       "are the runtime path's (phase 20 run C, one a frame), "
                       "stereo_path_launches the stereo path's (two a frame), "
                       "sharded_path_launches the --mesh 1 CLI run's (phase "
                       "21c), slam_path_launches "
                       "the SLAM path's (one a frame); pr4_route_ms is PR "
                       "4's route (pack_levels + patch_origins + the canvas "
                       "kernel, one graph) and canvas_kernel_ms its kernel "
                       "alone, timed in the same run, pr4_route_launches the "
                       "canvas kernel's launches on the SLAM path; plain_ms is "
                       "the whole extract_patches, library_ms one indexing "
                       "call with its index prebuilt",
        "shapes": [patch_time],
    })
    k5 = graphs["k5"]
    kernels.append({
        "name": "rigid_fit",
        "entries": ["rigid_fit", "rigid_refit"],
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/rigid_fit.cu",
        "replaces": "jetracer_orbslam2_tpu/ops/geometry.py:397",
        "launches": runtime_launches["rigid_fit"],
        "odometry_path_launches": graphs["odometry"]["launches"]["rigid_fit"],
        "slam_path_launches": slam_launches["rigid_fit"],
        "stereo_path_launches": stereo_launches["rigid_fit"],
        "max_abs_err": k5["max_err"],
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": None,
        "floor_ms": k5["floor_ms"],
        "fit_ms": k5["fit_ms"],
        "fit_plain_ms": k5["fit_plain_ms"],
        "fit_bound_ms": k5["fit_bound_ms"],
        "two_call_ms": k5["two_call_ms"],
        "numbers_are": "K5 has no Pallas counterpart: it replaces the SVD of "
                       "kabsch (jnp.linalg.svd in the JAX package, "
                       "torch.linalg.svd with a host wait as the plain "
                       "version); two entries counted together, rigid_fit "
                       "(one fit) and rigid_refit (fit, gate, fit: the "
                       "refit pair of ransac_kabsch and of the SLAM map "
                       "refit); ms, plain_ms, bound_ms are rigid_refit's per "
                       "launch at B 1, N 1,024 (every launch of the odometry "
                       "and plain SLAM frames is one), fit_* rigid_fit's, "
                       "two_call_ms the route the refit replaced (two fit "
                       "launches and the ops between, one graph); "
                       "max_abs_err is the worst rotation entry or "
                       "translation relative to the points' scale against "
                       "the plain route; plain_ms is the SVD route per eager "
                       "call (its host waits included); launches are the "
                       "runtime path's (phase 20 run C), "
                       "odometry_path_launches phase 22's graphed "
                       "odometry_scan's, slam_path_launches phase 13's, "
                       "stereo_path_launches phase 18's",
        "cases": k5["cases"],
        "refit_cases": k5["refit_cases"],
        "large_cases": k5["large_cases"],
        "large_times": k5["large_times"],
        "times": k5["times"],
        "split": k5["split"],
    })
    kernels.append({
        "name": "pose_polish",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/pose_polish.cu",
        "replaces": "jetracer_orbslam2_tpu/models/tracking.py:59",
        "launches": runtime_launches["pose_polish"],
        "odometry_path_launches": graphs["odometry"]["launches"]["pose_polish"],
        "slam_path_launches": slam_launches["pose_polish"],
        "stereo_path_launches": stereo_launches["pose_polish"],
        "max_abs_err": polish["max_err"],
        "ms": polish["ms"],
        "plain_ms": polish["plain_ms"],
        "bound_ms": polish["bound_ms"],
        "bound_by": polish["bound_by"],
        "library_ms": None,
        "floor_ms": polish["floor_ms"],
        "numbers_are": "K6 has no Pallas counterpart: it replaces the JAX "
                       "package's lax.scan of 5 Gauss-Newton steps "
                       "(refine_pose_reprojection, models/tracking.py:59-105), "
                       "which XLA fuses inside the jitted frame step; ms, "
                       "plain_ms, bound_ms per launch at B 1, K 1,024, 5 "
                       "steps (every launch of the main path is one); "
                       "max_abs_err is the worst rotation entry or "
                       "translation relative to the points' scale against "
                       "the plain version (the loop of small PyTorch ops it "
                       "replaced, CUDA events around 10 eager calls); no "
                       "single PyTorch call computes a Gauss-Newton polish; "
                       "launches are the runtime path's (phase 20 run C, "
                       "two a stepped frame), odometry_path_launches phase "
                       "22's graphed odometry_scan's, slam_path_launches "
                       "phase 13's, stereo_path_launches phase 18's",
        "cases": polish["cases"],
        "times": polish["times"],
        "odometry_frame": polish["odometry_frame"],
    })
    kernels.append({
        "name": "ransac_select",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/ransac_hyp.cu",
        "replaces": "jetracer_orbslam2_tpu/models/tracking.py:108",
        "launches": runtime_launches["ransac_select"],
        "odometry_path_launches": graphs["odometry"]["launches"]["ransac_select"],
        "slam_path_launches": slam_launches["ransac_select"],
        "stereo_path_launches": stereo_launches["ransac_select"],
        "sharded_path_launches": sharded_launches["ransac_select"],
        "max_abs_err": ransac["max_err"],
        "winners_moved": ransac["worst"]["winners_moved"],
        "w1_differ_near_gate": ransac["worst"]["w1_differ_near_gate"],
        "ms": ransac["ms"],
        "plain_ms": ransac["plain_ms"],
        "bound_ms": ransac["bound_ms"],
        "bound_by": ransac["bound_by"],
        "library_ms": None,
        "floor_ms": ransac["floor_ms"],
        "numbers_are": "K7 has no Pallas counterpart: it replaces the JAX "
                       "package's hypotheses, scores and argmax of "
                       "ransac_kabsch (models/tracking.py:108-150, with "
                       "ops/geometry.py:301 kabsch_quat), which XLA fuses "
                       "inside the jitted frame step; ms, plain_ms, bound_ms "
                       "per launch at B 1, H 256, K 1,024 (every launch of "
                       "the odometry path is one); max_abs_err is the "
                       "largest |w1 - the plain w1| over every case, points "
                       "within 1e-6 of their gate included, or 1 where a "
                       "winner moved (the gate excuses only such points: "
                       "w1_differ_near_gate counts them, winners_moved the "
                       "winners they moved); no single PyTorch call "
                       "computes RANSAC; launches are the runtime path's "
                       "(phase 20 run C, one a stepped frame and one a "
                       "verification or relocalization), "
                       "odometry_path_launches phase 22's graphed "
                       "odometry_scan's, slam_path_launches phase 13's, "
                       "stereo_path_launches phase 18's, "
                       "sharded_path_launches phase 21c's",
        "cases": ransac["cases"],
        "times": ransac["times"],
        "odometry_frame": ransac["odometry_frame"],
    })
    seconds = round(time.perf_counter() - t_start, 1)
    say(json.dumps({"main_path": report, "card": card, "seconds": seconds}))
    say(json.dumps({"ba_path": ba_report, "local_ba": local_report,
                    "pose_graph": pg_report, "card": card}))
    say(json.dumps({"slam_path": slam_report, "slam_lap": lap_report,
                    "map_lifecycle": lifecycle_report, "cli": cli_reports,
                    "card": card}))
    say(json.dumps({"stereo_path": stereo_report, "stereo_check": stereo_check,
                    "datasets": datasets_report, "card": card}))
    say(json.dumps({"runtime": runtime_report["summary"], "card": card}))
    say(json.dumps({"sharded": sharded_report, "card": card}))
    say(json.dumps({"graphs": graphs, "card": card}))
    say(json.dumps({"polish": polish, "card": card}))
    say(json.dumps({"ransac": ransac, "card": card}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
