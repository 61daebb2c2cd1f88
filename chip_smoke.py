#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py             # no arguments, one GPU
    python3 chip_smoke.py --kernels   # phases 1-3, 6, 7, 11, 16 only
    python3 chip_smoke.py --branches  # phases 1, 2, 25 and 26 only

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
every path; phase 22 holds them against their eager steps.  A graph is
captured once per configuration and cached, as `jax.jit` compiles once: a
fresh state of a configuration already captured replays from its first
frame (phase 26), and the timed runs of phases 12, 13 and 18 are such
states, after one untimed run of the configuration (their cold start on a
line of its own).  It builds the
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
                  median ATE must stay under 58 cm; the timed runs are
                  fresh states on the cached graphs
  13 SLAM path    slam_scan over 1,200 frames of 640x480, three laps, map of
                  128 keyframe slots / 16,384 landmarks / 65,536 observations:
                  tracked fraction, loops, ATE, every kernel's launch count
                  (K6 twice a stepped frame: the tracker's and the map's
                  polish; K7 once a stepped frame, a relocalization tried
                  and a keyframe, whose top-n verifications are one launch;
                  no canvas packed); frames/s of the run, the frame graph's
                  nodes and the memory its capture reserved, and ms a frame
                  through the host-branch step in turns; then the same
                  frames through ChunkedSlam(mesh=make_mesh(1)) --chunked 8
                  (the sharded BA in the keyframe body): torch.equal to the
                  graphed run, the same bars, ms a frame in turns against
                  the host-branch step with the mesh
                  (an untimed 40-frame run first, for each route; the
                  timed runs replay the cached graphs)
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
                  kernel's launch count; frames/s of fresh states on the
                  cached graph (an untimed 30-frame run first)
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
                  ba_edges_dropped 0 (the --chunked 8 run replays the
                  frame graph with the mesh); (d)
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
                  capture, frames - 2 replays after one eager warm-up frame
                  (the cache cleared; a second run on the cached graph: no
                  capture, no eager frame, frames - 1 replays, 1 cache hit),
                  K1 = K4 = frames and K5 = K6 = K7 = stepped frames by
                  nodes x replays; (d) slam_scan (its frame graph) and Slam
                  (the tracking graph) against their eager steps: poses,
                  flags, keyframes, loops equal, no host wait in the scan,
                  one a plain frame of Slam, the frame graph one capture and
                  a replay a frame (a second run on the cached graph: no
                  capture, a replay a frame, 1 cache hit); the same equalities on the arc's first
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
                  (winner 0); a quadratic gate with a cap; B 8, B 3 at H
                  512 (a keyframe's loop verifications in one launch) and
                  the first 40 frames' problems of the odometry run as one
                  batch (each row equal to its problem alone); relaunch and
                  two graph replays torch.equal; the time a launch beside
                  the plain version's, the floor and the bound; through a
                  harness that includes the source, every cluster size the
                  wrapper can take (1-16), the points staged and read from
                  memory (the same outputs); the graphed
                  odometry frame's device kernels and copies and busy ms
                  beside those with the plain RANSAC, in turns
  25 branches     slam_scan's frame graph, whose relocalization and keyframe
                  branches (and the loop closure and compactions inside the
                  latter) are conditional nodes, against the host-branch
                  step `_step`: outputs, counters and every map tensor
                  torch.equal on the arc's first 60 frames with 30-33 blank
                  (it relocalizes), the gated lap (a loop closes) and three
                  laps in 32 slots (the map compacts); no host wait from
                  slam_scan's entry to the caller's fetch (sync debug
                  "error"); K7 once a stepped frame, a relocalization tried
                  and a keyframe, K2 = K3 = 10 x keyframes; each body's
                  device ms beside its count (two clock-mark nodes a body,
                  counted in its nodes), the keyframe body's covering the
                  bodies inside it; ChunkedSlam
                  --chunked 8 waits once a chunk; the lap's ms a frame
                  graphed and host-branch in turns; (d) with a one-rank
                  NCCL mesh (the keyframe body's BA sharded, its
                  all-reduces K8 launches in the body): the lap and the
                  lifecycle torch.equal to `_step` with the mesh and to the
                  meshless graph, no host wait to the fetch, K8 = 22 x
                  keyframes (an LM iteration's packed partials and its
                  cost, 10 iterations, the initial cost, the gather) and
                  the nodes of each body by type, ChunkedSlam --chunked 8
                  with the mesh one wait a chunk; K8 vs its plain version
                  (dist.all_reduce) at the body's payloads, relaunch and
                  replays torch.equal, µs; the host-branch route: a
                  one-rank NCCL mesh whose K8 buffers are released after
                  set-up (a group K8 cannot serve) runs slam_scan and
                  ChunkedSlam through `_step`, names the route, launches
                  no K8 and equals `_step(plain_collectives=True)` and the
                  meshless graph, host waits counted; then K8 across
                  three ranks on the one card (processes over a gloo
                  group, the buffers mapped by CUDA IPC) at the body's
                  payloads and every launch shape (one block, several,
                  16, a tail not a multiple of 4, an unaligned tensor,
                  two chunks): torch.equal to the rank-order sum of the
                  ranks' inputs, within 1e-6 of the magnitudes' sum of the
                  group's all-reduce, relaunch and two replays, launches
                  counted; and 1,000 calls back to back over six payloads
                  with one rank started 2 s late, every output torch.equal;
                  every run of phase 25 is cold (the cache cleared first:
                  one capture and warm-up, no cache hit)
  26 graph cache  one captured graph per configuration: on the gated lap
                  the first frame of a fresh state after
                  clear_graph_cache(), split into warm-up, capture and
                  instantiation, and of a second fresh state of another
                  seed (0 captures, 0 warm-ups, 1 cache hit); slam_scan,
                  odometry_scan (three calls from one state, bench.py's
                  protocol), Slam, ChunkedSlam --chunked 8, the stereo lap
                  and ChunkedSlam with a one-rank mesh on the cached graph,
                  torch.equal (outputs, every state tensor, the generator's
                  state) to the same seed on a freshly captured graph; two
                  states interleaved chunk by chunk, each torch.equal to its
                  run alone, the bytes copied in at each switch; Mesh.close()
                  drops the mesh's graph; at the end the graphs held, hits,
                  misses, captures (never more than misses), and the device
                  memory reserved
  27 entry        ChunkedOdometry --chunked 8 as the benchmark drives it:
                  5 chunks of 8 and a tail of 3 of 640x480 pageable host
                  frames from one buffer rewritten after each call,
                  np.array_equal to odometry_scan on the same frames; under
                  sync debug "warn" no synchronising call in a call that
                  returns no chunk, two (the fetches) in one that completes
                  a chunk; no staging wait; frames/s of a closed loop of
                  240 frames and the device's idle share (a device-only
                  traced pass)
Launch counts: a wrapper counts one when it launches its kernel, a replay of
a captured frame step counts each kernel node of the graph once, and a
conditional body's kernels count once for each replay that took the body
(`utils/step_graph.note_launch`, `settle_launches`), so "once a frame" holds
either way.
Kernel times are CUDA events around a replayed CUDA graph of launches.  Then
the paths' reports (the stereo path's and the datasets' on one line, the
runtime's on one, the sharded phase's on one), one JSON line
`{"kernels": [...]}` (K1-K7, then K8; launches: the runtime path's, phase
20 run C, K8's phase 13's mesh run; sharded_path_launches the --mesh 1 CLI
run's, phase 21c), and as the last
line `{"ok": true, "device": {...}}`.  `csrc/graph_cond.cu`, built with the
kernels, makes the conditional nodes; it is no kernel of the TPU's.

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
N_PHASES = 27
BRANCHES_TITLE = (
    "branches: slam_scan's frame graph (relocalization and keyframe "
    "branches as conditional nodes) vs the host-branch step, torch.equal, "
    "no host wait (sync debug 'error'); ChunkedSlam one wait a chunk; "
    "launches by the branches taken; (d) the same with a one-rank NCCL mesh")
GRAPHS_TITLE = (
    "graphs: (a) K5 (rigid_fit, rigid_refit) vs the SVD route, (b) the eager "
    "odometry_step with no host wait, (c) odometry_scan's CUDA graph vs the "
    "eager step "
    "loop, (d) slam_scan's frame graph and Slam's tracking graph vs their "
    "eager steps, "
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
    """Every kernel's launches to 0 (K8's too), the branches of earlier
    frame graphs settled first (their launches belong before the reset)."""
    from jetracer_orbslam2_torch.ops import fused_allreduce
    from jetracer_orbslam2_torch.utils import step_graph

    step_graph.settle_launches()
    for fn in list(_kernel_counters().values()) + [
            fused_allreduce.peer_allreduce]:
        fn.launches = 0


def _k8_launches() -> int:
    """K8's launches since `_reset_counters` (read after `_read_counters`,
    which settles the branches): the mesh's all-reduces that a frame
    graph's keyframe body holds.  Apart from `_kernel_counters`, whose
    dictionaries the meshless gates compare whole."""
    from jetracer_orbslam2_torch.ops import fused_allreduce

    return fused_allreduce.peer_allreduce.launches


def _read_counters() -> dict:
    """Every kernel's launches, the branches of the frame graphs settled
    first (a body's kernels count once for each replay that took it, read
    from the replays' branch flags: one fetch)."""
    from jetracer_orbslam2_torch.utils import step_graph

    step_graph.settle_launches()
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


def _host_scan_pair(firsts, seconds, intr, cfg, state=None, mesh=None):
    """slam_scan's frames through `_step`, the host-branch step: the
    tracking half a replay of its tracking graph, the relocalization and
    keyframe branches eager host branches (with a mesh, the sharded BA's
    collectives eager too, and the group's own all-reduce, K8's plain
    version).  The reference the frame graph is held against.
    -> (final, out)."""
    import torch
    from jetracer_orbslam2_torch.models import slam as slam_mod
    from jetracer_orbslam2_torch.models import slam_scan as ss

    if state is None:
        state = ss.init_scan_state(firsts[0], seconds[0], intr, cfg)
    dev = state.T_wc.device
    const = slam_mod.step_constants(dev)
    rows = []
    for i in range(1, firsts.shape[0]):
        state, row = ss._step(state, firsts[i], seconds[i], (None, False),
                              intr, cfg, mesh, plain_collectives=True)
        rows.append(row[:4] + (const["true" if row[4] else "false"],))
    ref_uid, T_rel, T_w_emit, tracked, is_kf = zip(*rows)
    return state, ss.ScanOutput(
        ref_uid=torch.stack(ref_uid), T_rel=torch.stack(T_rel),
        T_w_emit=torch.stack(T_w_emit), tracked=torch.stack(tracked),
        is_kf=torch.stack(is_kf))


def _branches_taken(final) -> dict:
    """How many of a scan's frames took each branch of its frame graph, from
    the graph's counts not yet settled (before `_read_counters`); {} for a
    scan that ran no frame graph."""
    from jetracer_orbslam2_torch.utils import step_graph

    graph = final.graph
    if not isinstance(graph, step_graph.FrameGraph):
        return {}
    counts = graph.branch_counts()
    taken = [0] * 5 if counts is None else counts[0].tolist()
    return dict(zip(("relocalization", "keyframe", "loop_close",
                     "compact_keyframes", "compact_map"), taken))


def _body_rows(names, counts, what: str) -> dict:
    """Each conditional body: the replays that took it and their device ms
    (the frame graph's clock marks at the body's edges), from the graph's
    (2, bodies) counts fetched to the host.  Every body taken has a time,
    and the keyframe body's covers the bodies inside it (loop closure and
    the compactions)."""
    rows = {name: {"taken": int(n), "device_ms": ns / 1e6,
                   "device_ms_each": ns / 1e6 / n if n else 0.0}
            for name, n, ns in zip(names, *counts.tolist())}
    untimed = [k for k, r in rows.items() if r["taken"] and r["device_ms"] <= 0]
    inner = sum(r["device_ms"] for k, r in rows.items()
                if k not in ("relocalization", "keyframe"))
    if untimed or ("keyframe" in rows
                   and rows["keyframe"]["device_ms"] < inner):
        raise SystemExit(f"FAIL: {what}: body times {rows}")
    return rows


def _bodies(final, what: str) -> dict:
    """`_body_rows` of a scan's frame graph since its last settle, which
    this settles; {} for a scan that ran no frame graph."""
    from jetracer_orbslam2_torch.utils import step_graph

    graph = final.graph
    if not isinstance(graph, step_graph.FrameGraph):
        return {}
    counts = graph.branch_counts()
    if counts is None:
        return {}
    host = counts.cpu().numpy()
    graph.settle(host)
    return _body_rows(graph.body_names, host, what)


def _k7_exact(launches: dict, stepped: int, taken: dict, what: str) -> None:
    """K7 launched once a stepped frame, once a relocalization tried and
    once a keyframe (its top-n verifications are one launch): exact since
    the branches' launches are counted by the branches taken."""
    want = stepped + taken["relocalization"] + taken["keyframe"]
    if launches["ransac_select"] != want:
        raise SystemExit(f"FAIL: {what}: ransac_select launched "
                         f"{launches['ransac_select']} times, {want} expected "
                         f"({stepped} stepped frames, branches {taken})")


def _check_obs_prefix(m, what: str) -> None:
    ok = m.obs_valid.cpu().numpy()
    count = int(m.num_obs)
    kf = m.obs_kf.cpu().numpy()[:count]
    if not (ok[:count].all() and not ok[count:].any() and (kf[1:] >= kf[:-1]).all()):
        raise SystemExit(f"FAIL: {what}: obs_kf is not sorted over its valid prefix")


def _cold_start(label: str, graph) -> dict:
    """A run's cold start on a line of its own: its graph handle's captures,
    warm-ups and cache hits, and the warm-up, capture and instantiate ms of
    the capture that made its graph (`StepGraph` ends the capture and
    instantiates in one step)."""
    row = {"captures": graph.captures, "warmups": graph.warmups,
           "cache_hits": graph.cache_hits, **graph.cold_start()}
    say(f"  cold start, {label}: " + json.dumps(row))
    return row


def phase_slam_lap(dev) -> dict:
    """The gated lap: slam_scan and Slam on the same noisy frames, then the
    lap with and without loop closure over LAP_NOISE_SEEDS draws of the noise."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, LoopClosureConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models.slam import Slam
    from jetracer_orbslam2_torch.utils import step_graph

    h, w = LAP_SHAPE
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0))
    seq, depth = _lap(LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE, 0, dev)
    # one untimed run of each configuration, as bench.py compiles before it
    # times: the timed runs are fresh states on the cached graphs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm_final, _, warm_poses, _ = _scan(seq, depth, cfg)
    torch.cuda.synchronize()
    cold = {"scan": _cold_start("gated lap, slam_scan's untimed run",
                                warm_final.graph)}
    cold["scan"]["run_s"] = time.perf_counter() - t0
    warm_slam = Slam(cfg, seq.intrinsics)
    for i in range(3):
        warm_slam.process_frame(seq.gray[i], depth[i])
    cold["slam"] = _cold_start("gated lap, Slam's untimed first frames",
                               warm_slam._graphs["rgbd"])
    del warm_final, warm_slam
    step_graph.settle_launches()    # the bodies' times below are the runs'
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
            "loops": int(final.num_loops),
            "bodies": _bodies(final, f"gated lap, noise seed {noise_seed}"),
            "relocs": int(final.num_relocs),
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
        "fps_are": "fresh states on the cached graphs (host clock)",
        "scan_cache_hits": final.graph.cache_hits,
        "slam_cache_hits": slam._graphs["rgbd"].cache_hits,
        "cold_start": cold,
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
    if (report["scan_cache_hits"], report["slam_cache_hits"]) != (1, 1):
        raise SystemExit(f"FAIL: the timed lap runs did not replay the cached "
                         f"graphs: {report}")
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
    # warm-up on the first frames: every shape of the run has been seen once;
    # the device memory the frame graph's capture reserves (its pool and
    # its branches' pools) is read around it
    # (bench.py's compile before it times: the timed run is a fresh state on
    # the cached graph; the warm-up's and the capture's calls are counted
    # with the timed run's)
    warm = seq._replace(gray=seq.gray[:40], depth=depth[:40], poses=seq.poses[:40])
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    with counting_calls() as warm_calls:
        warm_final, _, _, _ = _scan(warm, depth[:40], cfg)
    torch.cuda.synchronize()
    pool_bytes = torch.cuda.memory_reserved() - reserved0
    fg_nodes = (warm_final.graph.graph_nodes, warm_final.graph.body_nodes)
    cold = _cold_start("SLAM path, the untimed 40 frames", warm_final.graph)
    del warm_final
    _reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with counting_calls() as calls:
        start.record()
        final, out, poses, rmse = _scan(seq, depth, cfg)
        stop.record()
        stop.synchronize()
    taken = _branches_taken(final)
    bodies = _bodies(final, "SLAM path")
    launches = _read_counters()
    ms = start.elapsed_time(stop)
    calls = {k: v + warm_calls[k] for k, v in calls.items()}
    inserted = int(out.is_kf.sum())
    m = final.m
    k1_k4 = _without_k5_k7(launches, LONG_FRAMES - 1, "SLAM path")
    _k7_exact(launches, LONG_FRAMES - 1, taken, "SLAM path")
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
        "branches_taken": taken, "bodies": bodies,
        "frame_graph": {
            "nodes": fg_nodes[0], "body_nodes": fg_nodes[1],
            "captures": final.graph.captures, "replays": final.graph.replays,
            "cache_hits": final.graph.cache_hits,
            "reserved_bytes_by_warm_scan": pool_bytes, "cold_start": cold},
    }
    if (final.graph.captures, final.graph.cache_hits) != (0, 1):
        raise SystemExit(f"FAIL: SLAM path: the timed run did not replay the "
                         f"cached graph: {report['frame_graph']}")
    # the same frames through the host-branch step (the tracking half a graph
    # replay, the branches eager), against the frame graph, in turns; the
    # host-branch step's tracking graph captured by an untimed run first
    _host_scan_pair(seq.gray[:40], depth[:40], seq.intrinsics, cfg)
    turns = {"graphed": [ms]}
    for name in ("host", "host", "graphed"):
        torch.cuda.synchronize()
        start.record()
        if name == "host":
            _host_scan_pair(seq.gray, depth, seq.intrinsics, cfg)
        else:
            _scan(seq, depth, cfg)
        stop.record()
        stop.synchronize()
        turns.setdefault(name, []).append(start.elapsed_time(stop))
    report["ms_per_frame_in_turns"] = {
        k: [t / LONG_FRAMES for t in v] for k, v in turns.items()}
    report["turns"] = "graphed (the gated run), host, host, graphed"
    report["mesh"] = _slam_path_mesh(seq, depth, cfg, final, out)
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


def _slam_path_mesh(seq, depth, cfg, final, out) -> dict:
    """Phase 13's frames through `ChunkedSlam(mesh=make_mesh(1))` (--chunked
    8 on a one-rank NCCL group: the frame graph with the sharded windowed BA
    in its keyframe body), torch.equal to the meshless graphed run (final,
    out) and at its bars; ms a frame against the host-branch step with the
    same mesh, in turns (chunked, host, host, chunked)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.parallel import make_mesh

    if dist.is_initialized():
        raise SystemExit("FAIL: a process group is still up before phase 13's "
                         "mesh run")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    mesh = make_mesh(1)
    turns, report = {}, {}
    try:
        # one untimed run of the configuration with this mesh: the gated
        # run is a fresh state on the cached mesh graph
        warm = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=CHUNK, mesh=mesh)
        for i in range(40):
            warm.process_frame(seq.gray[i], depth[i])
        warm.flush()
        cold = _cold_start("SLAM path with the mesh, the untimed 40 frames",
                           warm.state.graph)
        _host_scan_pair(seq.gray[:40], depth[:40], seq.intrinsics, cfg,
                        mesh=mesh)
        del warm
        for name in ("chunked", "host", "host", "chunked"):
            if not report:
                _reset_counters()     # the gated run's launches
            torch.cuda.synchronize()
            start.record()
            if name == "chunked":
                ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=CHUNK,
                                    mesh=mesh)
                for i in range(LONG_FRAMES):
                    ch.process_frame(seq.gray[i], depth[i])
                ch.flush()
            else:
                _host_scan_pair(seq.gray, depth, seq.intrinsics, cfg, mesh=mesh)
            stop.record()
            stop.synchronize()
            turns.setdefault(name, []).append(
                start.elapsed_time(stop) / LONG_FRAMES)
            if name == "chunked" and not report:
                launches, k8 = _read_counters(), _k8_launches()
                whole = [o.cpu().numpy() for o in out]
                merged = [np.concatenate([getattr(o, f) for o in ch._outs])
                          for f in ss.ScanOutput._fields]
                differ = [f for f, a, b in zip(ss.ScanOutput._fields, merged,
                                               whole) if not np.array_equal(a, b)]
                differ += _differing_state(ch.state, final)
                poses = ch.result()
                report = {
                    "chunk": CHUNK, "chunks": len(ch._outs),
                    "equals_meshless_graph": not differ, "differing": differ,
                    "tracked_frac": float(np.mean(ch.tracked())),
                    "loops": int(ch.state.num_loops),
                    "ate_rmse_m": float(ate(torch.from_numpy(poses),
                                            seq.poses.cpu()).rmse),
                    "ba_edges_dropped": int(ch.state.ba_edges_dropped),
                    "keyframes_inserted": int(merged[4].sum()),
                    "k8_launches": k8,
                    "k2_k3_launches": [launches["fused_normal_schur"],
                                       launches["fused_backsub"]],
                    "captures": ch.state.graph.captures,
                    "replays": ch.state.graph.replays,
                    "cache_hits": ch.state.graph.cache_hits,
                    "body_nodes": ch.state.graph.body_nodes,
                    "cold_start": cold}
    finally:
        mesh.close()
    report["ms_per_frame_in_turns"] = turns
    report["turns"] = ("ChunkedSlam --chunked 8 with the mesh (the gated run), "
                       "host-branch step with the mesh, host, chunked")
    say("  SLAM path, mesh 1: " + json.dumps(report))
    if report["differing"]:
        raise SystemExit(f"FAIL: SLAM path: ChunkedSlam with the mesh differs "
                         f"from the meshless graph in {report['differing']}")
    if (report["captures"], report["cache_hits"]) != (0, 1):
        raise SystemExit(f"FAIL: SLAM path with the mesh: the gated run did "
                         f"not replay the cached graph: {report}")
    if (report["tracked_frac"] < 0.95 or report["loops"] < 1
            or not report["ate_rmse_m"] <= LONG_ATE_M
            or report["ba_edges_dropped"] != 0):
        raise SystemExit(f"FAIL: SLAM path with the mesh: {report}")
    inserted = report["keyframes_inserted"]
    if (report["k8_launches"] != K8_PER_KEYFRAME * inserted
            or report["k2_k3_launches"] != [10 * inserted] * 2):
        raise SystemExit(f"FAIL: SLAM path with the mesh: K8 launches "
                         f"{report['k8_launches']}, K2/K3 "
                         f"{report['k2_k3_launches']}, {inserted} keyframes")
    return report


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
    # one untimed run of the configuration (bench.py's compile): the timed
    # runs are fresh states on the cached graph; the untimed run's calls of
    # the canvas route are counted with each timed run's
    warm = seqs["arc"]
    with counting_calls() as warm_calls:
        warm_final, _, _, _ = _scan_pair(warm.left[:30], warm.right[:30],
                                         warm.intrinsics, warm.poses[:30], cfg)
    cold = _cold_start("stereo, the untimed 30 frames", warm_final.graph)
    del warm_final
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
        taken = _branches_taken(final)
        bodies = _bodies(final, f"stereo {name}")
        launches = _read_counters()
        ms = start.elapsed_time(stop)
        calls = {k: v + warm_calls[k] for k, v in calls.items()}
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
            "branches_taken": taken, "bodies": bodies,
            "cache_hits": final.graph.cache_hits,
            "captures": final.graph.captures, "untimed_run_cold_start": cold,
        }
        say(f"  stereo {name}: " + json.dumps(row))
        if (row["captures"], row["cache_hits"]) != (0, 1):
            raise SystemExit(f"FAIL: stereo {name}: the timed run did not "
                             f"replay the cached graph: {row}")
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
        _k7_exact(launches, STEREO_FRAMES - 1, taken, f"stereo {name}")
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
    updates (`slam.keyframe_update` called eagerly, as `Slam` calls it
    through the module; a `ChunkedSlam`, whose frames run in a frame graph
    with or without a mesh: its outputs' `is_kf`) and the final poses and
    tracked flags (`Slam.result`, `ChunkedSlam.result` / `tracked`)."""

    def __enter__(self):
        from jetracer_orbslam2_torch.models import slam as slam_mod
        from jetracer_orbslam2_torch.models import slam_scan as ss
        from jetracer_orbslam2_torch.utils import step_graph

        self.keyframe_updates, self.poses, self.tracked = 0, None, None
        probe, self._saved = self, []

        def patch(owner, name, make):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, make(fn))

        def counted(fn):
            def wrapped(*a, **kw):
                # a frame graph calls it once to warm up and once to capture;
                # its keyframes are the chunks' is_kf (chunk_result below)
                if not step_graph.in_graph():
                    probe.keyframe_updates += 1
                return fn(*a, **kw)
            return wrapped

        def chunk_result(fn):
            def wrapped(ch, *a, **kw):
                out = fn(ch, *a, **kw)
                probe.poses = out
                if isinstance(ch.state.graph, step_graph.FrameGraph):
                    probe.keyframe_updates = int(sum(
                        o.is_kf.sum() for o in ch._outs))
                return out
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
        patch(ss.ChunkedSlam, "result", chunk_result)
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
        if extra and (rm.get("scan_route"), r0.get("scan_route")) != (
                "frame_graph", "frame_graph"):
            bad.append(f"{name}: scan_route {rm.get('scan_route')} / "
                       f"{r0.get('scan_route')} (frame_graph expected: K8 "
                       f"serves a one-rank mesh)")
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
    first.  The cache is cleared first: phases 23 and 24 swap a function
    of the step (K6, K7 against their plain versions), which no key of the
    graph cache names, so each turn captures its own graph."""
    from jetracer_orbslam2_torch.models import odometry as odo
    from jetracer_orbslam2_torch.utils import step_graph

    step_graph.clear_graph_cache()
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
    from jetracer_orbslam2_torch.utils import step_graph

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
    # the first graphed run is cold (the cache cleared: it warms up and
    # captures), the second a fresh state on the cached graph
    step_graph.clear_graph_cache()
    _reset_counters()
    walls["graphed"] = [_timed(graphed)]
    launches = _read_counters()
    poses, oks, graph = runs["graphed"]
    walls["graphed"].append(_timed(graphed))
    cached = runs["graphed"][2]
    walls["eager"].append(_timed(eager))
    same = (torch.equal(poses, ref[0]) and torch.equal(oks, ref[1])
            and torch.equal(runs["graphed"][0], poses)
            and torch.equal(runs["graphed"][1], oks)
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
        "cached_run": {"captures": cached.captures, "replays": cached.replays,
                       "eager_calls": cached.eager_calls,
                       "cache_hits": cached.cache_hits},
        "cold_start": graph.cold_start(),
        "nodes": {fn.__name__: k for fn, k in graph.nodes.items()},
        "launches": launches,
        "ms_per_frame": {k: [w / (n - 1) * 1e3 for w in v]
                         for k, v in walls.items()},
        "device_busy_ms_per_frame": {k: b[1] / window * 1e3
                                     for k, b in busy.items()},
        "device_kernels_per_frame": {k: b[2] / window for k, b in busy.items()},
        "traced_ms_per_frame": {k: b[0] / window * 1e3 for k, b in busy.items()},
        "idle_share": {k: 1 - b[1] / b[0] for k, b in busy.items()},
        "turns": "eager, graphed (cold), graphed (cached), eager over every "
                 f"frame; then frames {BUSY[0]}-{BUSY[1] - 1} of each, traced "
                 "on the device",
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
    if (graph.captures, graph.replays, graph.eager_calls,
            graph.cache_hits) != (1, n - 2, 1, 0) or got != want:
        raise SystemExit(f"FAIL: odometry graph: captures {graph.captures}, "
                         f"replays {graph.replays}, eager calls "
                         f"{graph.eager_calls}, cache hits {graph.cache_hits}, "
                         f"launches {got}; expected 1, {n - 2}, 1, 0, {want}")
    if (cached.captures, cached.replays, cached.eager_calls,
            cached.cache_hits) != (0, n - 1, 0, 1):
        raise SystemExit(f"FAIL: odometry graph, the cached run: "
                         f"{report['cached_run']}; expected 0 captures, "
                         f"{n - 1} replays, 0 eager calls, 1 cache hit")
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
    """(d) slam_scan (its frame graph) and Slam (its tracking graph) against
    their eager steps on the arc: poses, flags, keyframes, loops equal; no
    host wait in the whole scan, one a plain frame of Slam; (e) the scan
    timed in turns, and its device-busy share."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.evaluation import ate
    from jetracer_orbslam2_torch.models import slam as slam_mod
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.utils import step_graph

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
    step_graph.clear_graph_cache()               # a cold run: it captures
    _reset_counters()
    ss._step, slam_mod.Slam._track = scan_step, slam_track
    try:
        # the frame graph: warm-up, capture and every replay, no host wait
        (final, out), scan_waits = _count_waits(scan)
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
    # Slam's plain frames (tracked, no keyframe) after the capture (a run's
    # first tracked frame warms up, its second captures); a keyframe frame
    # and a relocalization wait more.  The scan's frames are replays of its
    # frame graph, which make no host wait at all (the whole scan's count)
    if waits["scan"]:
        raise SystemExit("FAIL: slam_scan took the host-branch step")
    plain = {"slam": [w for w, is_plain in waits["slam"][2:] if is_plain]}
    walls = {"eager": [_timed(lambda: scan(eager=True))]}
    held = {}
    walls["graphed"] = [_timed(lambda: held.update(run=scan())), _timed(scan)]
    cached = held["run"][0].graph            # a fresh state, the cached graph
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
        "cached_run": {"captures": cached.captures, "replays": cached.replays,
                       "eager_calls": cached.eager_calls,
                       "warmups": cached.warmups,
                       "cache_hits": cached.cache_hits},
        "launches": launches,
        "plain_frames": {k: len(v) for k, v in plain.items()},
        "host_waits_per_plain_frame": {
            k: (sum(v) / len(v) if v else None) for k, v in plain.items()},
        "host_waits_max_plain_frame": {k: max(v, default=None)
                                       for k, v in plain.items()},
        "scan_host_waits": scan_waits,
        "graph_nodes": graph.graph_nodes, "body_nodes": graph.body_nodes,
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
    if (graph.captures, graph.replays, graph.eager_calls,
            graph.cache_hits) != (1, n - 1, 0, 0):
        raise SystemExit(f"FAIL: SLAM frame graph captures {graph.captures}, "
                         f"replays {graph.replays}, eager calls "
                         f"{graph.eager_calls}, cache hits {graph.cache_hits}; "
                         f"expected 1, {n - 1}, 0, 0 (a warm-up on a copy, "
                         "then every frame a replay)")
    if (cached.captures, cached.replays, cached.eager_calls, cached.warmups,
            cached.cache_hits) != (0, n - 1, 0, 0, 1):
        raise SystemExit(f"FAIL: SLAM frame graph, the cached run: "
                         f"{report['cached_run']}; expected 0 captures, "
                         f"{n - 1} replays, 0 eager calls and warm-ups, 1 "
                         "cache hit")
    if scan_waits != 0:
        raise SystemExit(f"FAIL: slam_scan made {scan_waits} host waits "
                         "(none expected before the caller's fetch)")
    if launches["fast_nms_pyramid"] != n or launches["extract_patches_fused"] != n:
        raise SystemExit(f"FAIL: SLAM graph launches {launches}: K1 = K4 = {n} "
                         "expected")
    _without_k5_k7(launches, n - 1, "SLAM graph")
    if any(not v or max(v) != 1 or min(v) != 1 for v in plain.values()):
        raise SystemExit(f"FAIL: host waits of a plain Slam frame: {plain} "
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
# phase 25: the frame's branches as conditional nodes of its CUDA graph
# ---------------------------------------------------------------------------

CHUNK = 8                  # the CLI's --chunked 8


def _branch_sequences(source, args, dev) -> list:
    """(name, firsts, seconds, intrinsics, cfg, what the run must show) of
    phase 25: the CLI's arc with frames LOST[1]..LOST[2]-1 blank (it
    relocalizes), phase 12's lap (it closes loops) and phase 14's three laps
    through 32 keyframe slots (they compact)."""
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, MapConfig, SystemConfig, TrackingConfig)

    frames = list(source.frames())[:LOST[0]]
    gray = torch.stack([f[0] for f in frames]).clone()
    depth = torch.stack([f[1] for f in frames])
    gray[LOST[1]:LOST[2]] = 0
    arc_cfg = SystemConfig(frontend=run._frontend_cfg(args, source.hw, source.cal))
    h, w = LAP_SHAPE
    lap_cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0))
    lap, lap_depth = _lap(LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE, 0, dev)
    n_life = 3 * LAP_LENGTH + 16
    life, life_depth = _lap(LAP_SHAPE, n_life, LAP_LENGTH, LAP_NOISE, 0, dev)
    return [
        ("arc, frames 30-33 blank", gray, depth, source.intr, arc_cfg, "relocs"),
        ("gated lap", lap.gray, lap_depth, lap.intrinsics, lap_cfg, "loops"),
        ("lifecycle, 32 slots", life.gray, life_depth, life.intrinsics,
         lap_cfg.replace(map=MapConfig(max_keyframes=32)), "compactions"),
    ]


def _differing_state(a, b) -> list:
    """The fields of two ScanStates (every MapState tensor, the counters and
    poses) that are not torch.equal."""
    import torch

    bad = [f"m.{f}" for f, x, y in zip(type(a.m)._fields, a.m, b.m)
           if not torch.equal(x, y)]
    bad += [f"prev.{f}" for f, x, y in zip(type(a.prev)._fields, a.prev, b.prev)
            if not torch.equal(x, y)]
    for f in ("T_wc", "velocity", "frames_since_kf", "lost_streak", "frame_idx",
              "ref_slot", "num_loops", "num_relocs", "loop_prev_uid",
              "loop_consist", "ba_edges_dropped"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            bad.append(f)
    return bad


def _differing_run(a, b) -> list:
    """The outputs and state fields of two runs (final, out) that are not
    torch.equal."""
    import torch
    from jetracer_orbslam2_torch.models import slam_scan as ss

    (fa, oa), (fb, ob) = a, b
    return ([f for f in ss.ScanOutput._fields
             if not torch.equal(getattr(oa, f), getattr(ob, f))]
            + _differing_state(fa, fb))


def _branch_run(name, firsts, seconds, intr, cfg, must, dev, mesh=None,
                meshless=None) -> tuple:
    """One sequence of phase 25: the graphed scan under sync-debug "error"
    (no host wait from its entry to the caller's fetch), its outputs and
    branch flags in one fetch, torch.equal to the host-branch step, and the
    launches of the branch bodies by the branches taken.  mesh: the scan's
    and the host-branch step's (d); meshless: the meshless graphed run
    (final, out) it must equal too.  -> (row, final, out)."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.ops import fused_allreduce
    from jetracer_orbslam2_torch.utils import step_graph

    n = firsts.shape[0]
    state = ss.init_scan_state(firsts[0], seconds[0], intr, cfg)
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, out = ss.slam_scan(state, firsts[1:], seconds[1:], intr, cfg,
                                  mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = final.graph
    counts = graph.branch_counts()
    host = step_graph.fetch(*out, counts)       # the caller's one fetch
    graphed_s = time.perf_counter() - t0
    graph.settle(host[-1])
    launches = _read_counters()
    k8 = _k8_launches()
    taken = host[-1][0].tolist()
    bodies = _body_rows(graph.body_names, host[-1], f"phase 25, {name}")
    h_final, h_out = _host_scan_pair(firsts, seconds, intr, cfg, mesh=mesh)
    differ = _differing_run((final, out), (h_final, h_out))
    stepped = n - 1
    relocs_tried, keyframes = int(taken[0]), int(taken[1])
    row = {
        "sequence": name, "frames": n,
        "keyframes_inserted": int(out.is_kf.sum()), "keyframes": int(final.m.num_kf),
        "loops": int(final.num_loops), "relocs": int(final.num_relocs),
        "keyframes_recycled": int(final.m.num_dead),
        "tracked_frac": float(out.tracked.float().mean()),
        "branches_taken": {"relocalization": relocs_tried,
                           "keyframe": keyframes,
                           "loop_close": int(taken[2]),
                           "compact_keyframes": int(taken[3]),
                           "compact_map": int(taken[4])},
        "bodies": bodies,
        "graphed_equals_host_branch": not differ, "differing": differ,
        "captures": graph.captures, "replays": graph.replays,
        "warmups": graph.warmups, "cache_hits": graph.cache_hits,
        "graph_nodes": graph.graph_nodes, "body_nodes": graph.body_nodes,
        "body_node_types": graph.body_types,
        "launches": launches, "graphed_s_with_capture": graphed_s,
    }
    bad = []
    if mesh is not None:
        # the keyframe body is the second branch recorded (after the
        # relocalization's); its all-reduces, K8 launches, count once a
        # keyframe taken
        per_body = [b.get(fused_allreduce.peer_allreduce, 0)
                    for b in graph.bodies]
        differ_meshless = _differing_run((final, out), meshless)
        row.update(mesh_ranks=mesh.size, backend=mesh.backend,
                   route=final.route,
                   ba_edges_dropped=int(final.ba_edges_dropped),
                   k8_launches=k8, k8_per_body=per_body,
                   graphed_equals_meshless_graph=not differ_meshless,
                   differing_from_meshless=differ_meshless)
        if differ_meshless:
            bad.append(f"the mesh graph differs from the meshless graph in "
                       f"{differ_meshless}")
        if final.route != "frame_graph":
            bad.append(f"a mesh K8 serves took the {final.route} route")
        if row["ba_edges_dropped"] != 0:
            bad.append(f"ba_edges_dropped {row['ba_edges_dropped']}")
        if not (per_body[1] == K8_PER_KEYFRAME and k8 == per_body[1] * keyframes
                and sum(per_body) == per_body[1]):
            bad.append(f"K8 launches {k8}, per body {per_body}, {keyframes} "
                       f"keyframes ({K8_PER_KEYFRAME} a keyframe expected)")
    say(f"  {name}: " + json.dumps(row, default=str))
    if differ:
        bad.append(f"graphed differs from the host-branch step in {differ}")
    if keyframes != row["keyframes_inserted"] or int(taken[2]) != row["loops"]:
        bad.append("the branch flags disagree with is_kf or the loop count")
    # a cold run: each sequence's configuration (and mesh) is new to the
    # cache, which phase 25 clears first
    if (graph.captures, graph.replays, graph.warmups,
            graph.cache_hits) != (1, stepped, 1, 0):
        bad.append(f"captures {graph.captures}, replays {graph.replays}, "
                   f"warm-ups {graph.warmups}, cache hits {graph.cache_hits}")
    # counted from the first stepped frame (the bootstrap frame ran before)
    want = {"fast_nms_pyramid": stepped, "fused_normal_schur": 10 * keyframes,
            "fused_backsub": 10 * keyframes,
            "ransac_select": stepped + relocs_tried + keyframes}
    got = {k: launches[k] for k in want}
    if got != want:
        bad.append(f"launches {got}, expected {want}")
    if short := _k5_k7_short(launches, stepped):
        bad.append(short)
    need = {"relocs": row["relocs"], "loops": row["loops"],
            "compactions": row["branches_taken"]["compact_keyframes"]}[must]
    if need < 1:
        bad.append(f"no {must} on this sequence")
    if bad:
        raise SystemExit(f"FAIL: phase 25, {name}: " + "; ".join(bad))
    return row, final, out


def _chunked_waits(firsts, seconds, intr, cfg, whole_out, mesh=None) -> dict:
    """ChunkedSlam over CHUNK frames at a time on frames already on the
    card: host waits of every call counted (sync-debug "warn"); exactly one
    a chunk, in the call that returns it; the poses those of one scan."""
    import numpy as np
    from jetracer_orbslam2_torch.models import slam_scan as ss

    ch = ss.ChunkedSlam(cfg, intr, chunk_size=CHUNK, mesh=mesh)
    per_call, chunks = [], 0
    for i in range(firsts.shape[0]):
        out, k = _count_waits(lambda: ch.process_frame(firsts[i], seconds[i]))
        per_call.append(k)
        chunks += out is not None
        if (out is None and k) or (out is not None and k != 1):
            raise SystemExit(f"FAIL: ChunkedSlam frame {i}: {k} host waits "
                             f"(one in a call that returns a chunk, else none)")
    out, k = _count_waits(ch.flush)
    if out is not None:
        chunks += 1
        per_call.append(k)
        if k != 1:
            raise SystemExit(f"FAIL: ChunkedSlam's tail chunk: {k} host waits")
    same = bool(np.array_equal(ch.tracked()[1:], whole_out.tracked.cpu().numpy())
                and np.array_equal(np.concatenate([o.is_kf for o in ch._outs]),
                                   whole_out.is_kf.cpu().numpy()))
    report = {"chunk": CHUNK, "chunks": chunks, "host_waits": sum(per_call),
              "host_waits_per_chunk": sum(per_call) / chunks,
              "same_flags_as_one_scan": same,
              "mesh_ranks": None if mesh is None else mesh.size}
    say("  ChunkedSlam: " + json.dumps(report))
    if sum(per_call) != chunks or not same:
        raise SystemExit(f"FAIL: ChunkedSlam: {report}")
    return report


def phase_branches(source, args, dev) -> dict:
    """Phase 25: slam_scan's frame graph (the relocalization and keyframe
    branches as conditional nodes) against the host-branch step on three
    sequences, with no host wait; ChunkedSlam's one wait a chunk; the lap
    timed graphed and host-branch in turns."""
    import torch
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.utils import step_graph

    seqs = _branch_sequences(source, args, dev)
    step_graph.clear_graph_cache()           # every sequence's run is cold
    results = [_branch_run(*seq, dev) for seq in seqs]
    runs = [r[0] for r in results]
    _, lap, lap_depth, lap_intr, lap_cfg, _ = seqs[1]
    st = ss.init_scan_state(lap[0], lap_depth[0], lap_intr, lap_cfg)
    _, whole = ss.slam_scan(st, lap[1:], lap_depth[1:], lap_intr, lap_cfg)
    chunked = _chunked_waits(lap, lap_depth, lap_intr, lap_cfg, whole)
    mesh_report = _mesh_branches(seqs, results, whole, dev)
    turns, first = {}, {}
    for name in ("graphed", "host", "host", "graphed"):
        # frame 1 from a fresh state (on the graph the cache holds: the
        # cold start is phase 26's), then frames 2.. timed
        st = ss.init_scan_state(lap[0], lap_depth[0], lap_intr, lap_cfg)
        held = {}
        if name == "graphed":
            once = _timed(lambda: held.update(st=ss.slam_scan(
                st, lap[1:2], lap_depth[1:2], lap_intr, lap_cfg)[0]))
            wall = _timed(lambda: ss.slam_scan(held["st"], lap[2:],
                                                lap_depth[2:], lap_intr, lap_cfg))
        else:
            once = _timed(lambda: held.update(st=_host_scan_pair(
                lap[:2], lap_depth[:2], lap_intr, lap_cfg, st)[0]))
            wall = _timed(lambda: _host_scan_pair(
                lap[1:], lap_depth[1:], lap_intr, lap_cfg, held["st"]))
        first.setdefault(name, []).append(once * 1e3)
        turns.setdefault(name, []).append(wall / (LAP_FRAMES - 2) * 1e3)
    report = {"runs": runs, "chunked": chunked, "mesh": mesh_report,
              "lap_ms_per_frame_in_turns": turns,
              "lap_first_frame_ms": first,
              "turns": "graphed, host, host, graphed over the gated lap: "
                       "frames 2.. timed, after frame 1 from a fresh state "
                       "on the cached graphs (lap_first_frame_ms; phase 26 "
                       "splits the cold start)"}
    say("  branches: " + json.dumps({k: v for k, v in report.items()
                                     if k not in ("runs", "mesh")}))
    return report


def _host_branch_route(seq, meshless, dev) -> dict:
    """(d) a mesh on the card that K8 cannot serve: a one-rank NCCL mesh
    whose K8 buffers are released after set-up, and whose set-up record
    (`Mesh.k8_unservable`) says so, stands in for a group of more than 8
    ranks or several hosts (`map_peers` gives None there, and the mesh
    records why).
    `slam_scan` and `ChunkedSlam --chunked 8` on the gated lap take the
    host-branch route and name it, launch no K8, and their outputs,
    counters and map are torch.equal to `_step(plain_collectives=True)`'s
    and to the meshless graph's (final, out); host waits counted (sync
    debug "warn")."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.parallel import make_mesh

    name, firsts, seconds, intr, cfg, _ = seq
    if dist.is_initialized():
        raise SystemExit("FAIL: a process group is still up before the "
                         "host-branch route")
    mesh = make_mesh(1)
    try:
        mesh.peers.close()
        mesh.peers = None
        mesh.k8_unservable = "a stand-in for more than 8 ranks"
        shown = repr(mesh)
        state = ss.init_scan_state(firsts[0], seconds[0], intr, cfg)
        _reset_counters()
        (final, out), waits = _count_waits(lambda: ss.slam_scan(
            state, firsts[1:], seconds[1:], intr, cfg, mesh=mesh))
        launches = _read_counters()
        k8 = _k8_launches()
        h_final, h_out = _host_scan_pair(firsts, seconds, intr, cfg, mesh=mesh)
        differ_step = _differing_run((final, out), (h_final, h_out))
        differ_meshless = _differing_run((final, out), meshless)
        ch = ss.ChunkedSlam(cfg, intr, chunk_size=CHUNK, mesh=mesh)
        chunk_waits = 0
        for i in range(firsts.shape[0]):
            chunk_waits += _count_waits(
                lambda: ch.process_frame(firsts[i], seconds[i]))[1]
        chunk_waits += _count_waits(ch.flush)[1]
        merged = [np.concatenate([getattr(o, f) for o in ch._outs])
                  for f in ss.ScanOutput._fields]
        differ_chunked = [f for f, a, b in zip(ss.ScanOutput._fields, merged, out)
                          if not np.array_equal(a, b.cpu().numpy())]
        differ_chunked += _differing_state(ch.state, final)
    finally:
        mesh.close()
    stepped = firsts.shape[0] - 1
    keyframes = int(out.is_kf.sum())
    report = {
        "sequence": name, "mesh": shown, "route": final.route,
        "chunked_route": ch.route, "keyframes_inserted": keyframes,
        "loops": int(final.num_loops), "relocs": int(final.num_relocs),
        "equals_host_branch_plain": not differ_step,
        "equals_meshless_graph": not differ_meshless,
        "chunked_equals_scan": not differ_chunked,
        "differing": sorted(set(differ_step + differ_meshless
                                + differ_chunked)),
        "k8_launches": k8, "k2_launches": launches["fused_normal_schur"],
        "host_waits": waits, "host_waits_per_frame": waits / stepped,
        "chunked_host_waits": chunk_waits, "chunks": len(ch._outs)}
    say("  (d) host-branch route: " + json.dumps(report))
    if (report["route"], report["chunked_route"]) != ("host_branch",) * 2:
        raise SystemExit(f"FAIL: a mesh without K8's buffers took "
                         f"{report['route']} / {report['chunked_route']}")
    if (report["differing"] or k8 != 0 or keyframes < 1
            or launches["fused_normal_schur"] != 10 * keyframes):
        raise SystemExit(f"FAIL: the host-branch route: {report}")
    return report


def _mesh_branches(seqs, results, lap_whole, dev) -> dict:
    """(d) the same frame graph with a one-rank NCCL mesh: the windowed BA
    of the keyframe body is `sharded_local_ba`, its all-reduces and the
    gather of the landmark blocks nodes of that body.  On the gated lap and
    the 32-slot lifecycle: torch.equal to `_step` with the same mesh and to
    the meshless frame graph, no host wait from the scan's entry to the
    fetch (warm-up, the communicator's first collective and the capture
    included), K2 = K3 = 10 x keyframes; then ChunkedSlam --chunked 8 with
    the mesh on the lap, one wait a chunk."""
    import torch.distributed as dist
    from jetracer_orbslam2_torch.parallel import make_mesh

    if dist.is_initialized():
        raise SystemExit("FAIL: a process group is still up before (d)")
    mesh = make_mesh(1)
    try:
        rows = []
        for seq, (_, final, out) in zip(seqs[1:], results[1:]):
            row, _, _ = _branch_run(*seq, dev, mesh=mesh, meshless=(final, out))
            rows.append(row)
        _, lap, lap_depth, lap_intr, lap_cfg, _ = seqs[1]
        chunked = _chunked_waits(lap, lap_depth, lap_intr, lap_cfg, lap_whole,
                                 mesh=mesh)
        k8 = _k8_check(mesh, dev)
    finally:
        mesh.close()
    host_route = _host_branch_route(seqs[1], results[1][1:], dev)
    k8_ranks = _k8_ranks()
    report = {"runs": rows, "chunked": chunked, "k8": k8, "k8_ranks": k8_ranks,
              "host_branch_route": host_route}
    say("  (d) mesh: " + json.dumps(
        {r["sequence"]: {k: r[k] for k in (
            "graphed_equals_host_branch", "graphed_equals_meshless_graph",
            "body_nodes", "k8_launches", "k8_per_body",
            "ba_edges_dropped")} for r in rows}))
    return report


# ---------------------------------------------------------------------------
# phase 26: one captured graph per configuration (the graph cache)
# ---------------------------------------------------------------------------

GRAPH_CACHE_TITLE = (
    "graph cache: one captured graph per configuration, as jax.jit compiles "
    "one program per configuration: the gated lap's cold start split and a "
    "second state's cached start; cached runs torch.equal to runs on a "
    "freshly captured graph (slam_scan, odometry_scan three times from one "
    "state, Slam, ChunkedSlam --chunked 8, the stereo lap, the one-rank "
    "mesh ChunkedSlam); two states interleaved chunk by chunk")
CACHE_SEED = 1           # the second state's seed (the first's is 0)


def _first_frame_run(firsts, seconds, intr, cfg, seed: int) -> tuple:
    """slam_scan from a fresh state of `seed`: its first frame alone, timed
    on the host clock with the device synchronized around it, then the
    rest.  -> (final, out, first-frame ms)."""
    import torch
    from jetracer_orbslam2_torch.models import slam_scan as ss

    state = ss.init_scan_state(firsts[0], seconds[0], intr, cfg, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, first = ss.slam_scan(state, firsts[1:2], seconds[1:2], intr, cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    final, rest = ss.slam_scan(state, firsts[2:], seconds[2:], intr, cfg)
    out = ss.ScanOutput(*(torch.cat([a, b]) for a, b in zip(first, rest)))
    return final, out, first_ms


def _run_counters(graph) -> dict:
    return {"captures": graph.captures, "warmups": graph.warmups,
            "cache_hits": graph.cache_hits, "replays": graph.replays,
            "eager_calls": graph.eager_calls}


def _same_generator(a, b) -> bool:
    return bool(a.get_state().equal(b.get_state()))


def _cached_against_fresh(name: str, run, bad: list) -> dict:
    """`run()` -> (outputs, state, generator, graph handle) of one seed's run
    from a fresh state; run twice: on the graph the cache holds (it must
    capture nothing, warm nothing up and hit the cache once), then after
    clear_graph_cache() (it captures).  Outputs, every state tensor and the
    generator's state afterwards must be torch.equal."""
    import torch
    from jetracer_orbslam2_torch.utils import step_graph

    run()                                    # the cache holds the graph
    cached = run()
    step_graph.clear_graph_cache()
    fresh = run()
    differ = [f"output {i}" for i, (a, b) in enumerate(zip(cached[0], fresh[0]))
              if not torch.equal(a, b)]
    differ += [f"state {i}" for i, (a, b) in enumerate(zip(cached[1], fresh[1]))
               if not torch.equal(a, b)]
    if not _same_generator(cached[2], fresh[2]):
        differ.append("generator")
    row = {"cached": _run_counters(cached[3]), "fresh": _run_counters(fresh[3]),
           "equal": not differ, "differing": differ}
    say(f"  cached vs fresh, {name}: " + json.dumps(row))
    if differ:
        bad.append(f"{name}: the cached run differs from the fresh capture "
                   f"in {differ}")
    if (row["cached"]["captures"], row["cached"]["warmups"],
            row["cached"]["cache_hits"]) != (0, 0, 1):
        bad.append(f"{name}: the cached run {row['cached']}")
    if row["fresh"]["cache_hits"] != 0 or row["fresh"]["captures"] != 1:
        bad.append(f"{name}: the fresh run {row['fresh']}")
    return row


def _scan_tensors(final, out) -> tuple:
    """(outputs, every state tensor) of a scan, flat."""
    from jetracer_orbslam2_torch.models import slam_scan as ss

    state = []
    for f in ss._CARRIED:
        v = getattr(final, f)
        state.extend(v if isinstance(v, tuple) else (v,))
    return tuple(out), tuple(state)


def _interleaved(lap, lap_depth, intr, cfg, alone: dict, bad: list) -> dict:
    """Two states (seeds 0 and CACHE_SEED) take turns CHUNK frames at a time
    through slam_scan, one cached graph: each must be torch.equal to its
    run alone (`alone[seed]` = (final, out)); the bytes of state each turn
    copies into the graph's buffers."""
    import torch
    from jetracer_orbslam2_torch.models import slam_scan as ss

    seeds = (0, CACHE_SEED)
    states = {s: ss.init_scan_state(lap[0], lap_depth[0], intr, cfg, seed=s)
              for s in seeds}
    outs = {s: [] for s in seeds}
    copied = {s: [] for s in seeds}
    for i in range(1, lap.shape[0], CHUNK):
        for s in seeds:
            st = states[s]
            before = 0 if st.graph is None else st.graph.state_bytes_in
            st, out = ss.slam_scan(st, lap[i:i + CHUNK], lap_depth[i:i + CHUNK],
                                   intr, cfg)
            states[s] = st
            outs[s].append(out)
            copied[s].append(st.graph.state_bytes_in - before)
    differ = {}
    for s in seeds:
        out = ss.ScanOutput(*(torch.cat(f) for f in zip(*outs[s])))
        d = _differing_run((states[s], out), alone[s])
        if not _same_generator(states[s].generator, alone[s][0].generator):
            d.append("generator")
        differ[s] = d
    shared = states[0].graph._shared is states[CACHE_SEED].graph._shared
    row = {"chunk": CHUNK, "turns": len(copied[0]),
           "one_graph": shared,
           "state_bytes_copied_at_each_switch": copied,
           "equal_to_alone": {s: not d for s, d in differ.items()},
           "differing": differ,
           "run_counters": {s: _run_counters(states[s].graph) for s in seeds}}
    say("  interleaved: " + json.dumps(row))
    if any(differ.values()) or not shared:
        bad.append(f"interleaved states: {differ}, one graph {shared}")
    if any(c == 0 for c in copied[0] + copied[CACHE_SEED]):
        bad.append("a switch of states copied no state into the buffers")
    return row


def phase_graph_cache(source, args, dev) -> dict:
    """Phase 26: one captured graph per configuration.  On the gated lap:
    the cold start after clear_graph_cache() split into warm-up, capture
    and instantiation, and a second fresh state of another seed on the
    cached graph (0 captures, 0 warm-ups, 1 cache hit); then each entry
    point's cached run torch.equal to the same seed's run on a freshly
    captured graph, and two states interleaved chunk by chunk."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.io.synthetic import generate_stereo_lap_sequence
    from jetracer_orbslam2_torch.models import odometry as odo
    from jetracer_orbslam2_torch.models import slam as slam_mod
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.parallel import make_mesh
    from jetracer_orbslam2_torch.utils import step_graph

    bad: list = []
    h, w = LAP_SHAPE
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3, max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0))
    seq, depth = _lap(LAP_SHAPE, LAP_FRAMES, LAP_LENGTH, LAP_NOISE, 0, dev)
    lap, intr = seq.gray, seq.intrinsics

    # the cold start and a second state's cached start
    step_graph.clear_graph_cache()
    cold_final, cold_out, cold_ms = _first_frame_run(lap, depth, intr, cfg, 0)
    cold = {"first_frame_ms": cold_ms, **_run_counters(cold_final.graph),
            **cold_final.graph.cold_start()}
    cached_final, cached_out, cached_ms = _first_frame_run(
        lap, depth, intr, cfg, CACHE_SEED)
    cached = {"first_frame_ms": cached_ms, "seed": CACHE_SEED,
              "state_bytes_copied_in": cached_final.graph.state_bytes_in,
              **_run_counters(cached_final.graph)}
    say(f"  cold start, gated lap (the cache cleared, seed 0): "
        + json.dumps(cold))
    say(f"  cached start, gated lap (a second fresh state, seed "
        f"{CACHE_SEED}): " + json.dumps(cached))
    say(f"  first frame: cold {cold_ms:.2f} ms (warm-up "
        f"{cold.get('warmup_ms', 0):.2f} ms host / "
        f"{cold.get('warmup_device_ms', 0):.2f} ms device, capture "
        f"{cold.get('capture_ms', 0):.2f} ms, instantiate "
        f"{cold.get('instantiate_ms', 0):.2f} ms), cached {cached_ms:.2f} ms; "
        f"{card_line()}")
    n = lap.shape[0]
    if (cold["captures"], cold["warmups"], cold["cache_hits"],
            cold["replays"]) != (1, 1, 0, n - 1):
        bad.append(f"the cold run {cold}")
    if (cached["captures"], cached["warmups"], cached["cache_hits"],
            cached["replays"]) != (0, 0, 1, n - 1):
        bad.append(f"the cached run {cached}")

    equal = {}

    def scan_run(firsts, seconds, intr_, cfg_):
        def go():
            st = ss.init_scan_state(firsts[0], seconds[0], intr_, cfg_,
                                    seed=CACHE_SEED)
            final, out = ss.slam_scan(st, firsts[1:], seconds[1:], intr_, cfg_)
            return (*_scan_tensors(final, out), final.generator, final.graph)
        return go

    equal["slam_scan"] = _cached_against_fresh(
        "slam_scan, gated lap", scan_run(lap, depth, intr, cfg), bad)
    # the alone runs the interleaving is held to: seed 0 (the cold run) and
    # CACHE_SEED on the cached graph
    alone = {0: (cold_final, cold_out), CACHE_SEED: (cached_final, cached_out)}
    equal["interleaved"] = _interleaved(lap, depth, intr, cfg, alone, bad)
    del cold_final, cold_out, cached_final, cached_out, alone

    # odometry_scan three times from one state0, as bench.py times it: the
    # generator set back to state0's before each call
    frames = list(source.frames())
    gray = torch.stack([f[0] for f in frames])
    gdepth = torch.stack([f[1] for f in frames])
    fcfg, tcfg = run._frontend_cfg(args, source.hw, source.cal), TrackingConfig()
    step_graph.clear_graph_cache()
    st0 = odo.init_state(gray[0], gdepth[0], source.intr, fcfg, tcfg,
                         seed=CACHE_SEED)
    g0 = st0.generator.get_state()
    calls = []
    for _ in range(3):
        st0.generator.set_state(g0)
        final, poses, oks = odo.odometry_scan(st0, gray[1:], gdepth[1:],
                                              source.intr, fcfg, tcfg)
        calls.append((final, poses, oks, final.generator.get_state()))
    odo_differ = [
        k for k, (final, poses, oks, gen) in enumerate(calls[1:], 1)
        if not (torch.equal(poses, calls[0][1]) and torch.equal(oks, calls[0][2])
                and torch.equal(gen, calls[0][3])
                and all(torch.equal(a, b) for a, b in
                        zip(final.prev, calls[0][0].prev))
                and torch.equal(final.T_wc, calls[0][0].T_wc))]
    equal["odometry_scan"] = {
        "calls": [_run_counters(c[0].graph) for c in calls],
        "equal": not odo_differ, "differing_calls": odo_differ}
    say("  odometry_scan x3 from one state0: "
        + json.dumps(equal["odometry_scan"]))
    nf = gray.shape[0]
    want = [(1, 1, 0, nf - 2), (0, 0, 1, nf - 1), (0, 0, 1, nf - 1)]
    got = [(c["captures"], c["warmups"], c["cache_hits"], c["replays"])
           for c in equal["odometry_scan"]["calls"]]
    if odo_differ or got != want:
        bad.append(f"odometry_scan x3: differing calls {odo_differ}, "
                   f"counters {got}, expected {want}")
    del calls

    def slam_run():
        s = slam_mod.Slam(cfg, intr, seed=CACHE_SEED)
        for i in range(n):
            s.process_frame(lap[i], depth[i])
        o = s.result()
        outs = (torch.from_numpy(np.ascontiguousarray(o.poses)),
                torch.from_numpy(np.asarray(o.tracked)),
                torch.tensor([o.num_keyframes, o.num_loops, o.num_relocs]))
        return outs, tuple(s.m) + (s.T_wc, s.velocity), s.generator, \
            s._graphs["rgbd"]

    equal["slam"] = _cached_against_fresh("Slam, gated lap", slam_run, bad)

    def chunked_run(mesh=None, firsts=lap, seconds=depth, intr_=intr,
                    cfg_=cfg):
        def go():
            ch = ss.ChunkedSlam(cfg_, intr_, chunk_size=CHUNK, seed=CACHE_SEED,
                                mesh=mesh)
            for i in range(firsts.shape[0]):
                ch.process_frame(firsts[i], seconds[i])
            ch.flush()
            outs = tuple(torch.from_numpy(np.concatenate(
                [getattr(o, f) for o in ch._outs])) for f in ss.ScanOutput._fields)
            _, state = _scan_tensors(ch.state, ())
            return outs, state, ch.state.generator, ch.state.graph
        return go

    equal["chunked"] = _cached_against_fresh(
        f"ChunkedSlam --chunked {CHUNK}, gated lap", chunked_run(), bad)

    stereo_cfg = SystemConfig(
        frontend=FrontendConfig(height=480, width=640,
                                fast_min_threshold=SLAM_FAST_MIN_THRESHOLD),
        tracking=TrackingConfig(max_depth=80.0),
        stereo=StereoConfig(baseline=STEREO_BASELINE))
    stereo = generate_stereo_lap_sequence(
        STEREO_FRAMES, (480, 640), lap_frames=STEREO_LAP,
        baseline=STEREO_BASELINE, device=dev)
    equal["stereo_lap"] = _cached_against_fresh(
        "slam_scan, stereo lap",
        scan_run(stereo.left, stereo.right, stereo.intrinsics, stereo_cfg), bad)
    del stereo

    # the one-rank mesh ChunkedSlam; then Mesh.close() drops its graph
    mesh = make_mesh(1)
    try:
        mesh_go = chunked_run(mesh)
        equal["mesh_chunked"] = _cached_against_fresh(
            f"ChunkedSlam(mesh=make_mesh(1)) --chunked {CHUNK}, gated lap",
            mesh_go, bad)
        held = mesh_go()[3]
        before = step_graph.graph_cache_info()
    finally:
        mesh.close()
    after = step_graph.graph_cache_info()
    carried = tuple(held.carry())
    try:
        held(carried, lap[1], depth[1],
             *ss._imu_inputs((None, False), lap.device), intr)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    dropped = {"dropped": after["dropped"] - before["dropped"],
               "held_before": before["held"], "held_after": after["held"],
               "a_held_graph_raises": raised}
    say("  Mesh.close(): " + json.dumps(dropped))
    if dropped["dropped"] < 1 or raised is None:
        bad.append(f"Mesh.close() kept its graph: {dropped}")
    equal["mesh_close"] = dropped
    del held, carried

    report = {"cold": cold, "cached": cached, "equal": equal}
    if bad:
        raise SystemExit("FAIL: phase 26: " + "; ".join(bad))
    return report


ARRIVAL_TITLE = (
    "entry: ChunkedOdometry --chunked 8 replays each frame in the call that "
    "hands it in, its copy through pinned staging on a copy stream: 5 chunks "
    "of 8 and a tail of 3 of 640x480 pageable host frames from one reused "
    "buffer, np.array_equal to odometry_scan; host waits a call (sync debug "
    "'warn'); staging waits; frames/s and the device's idle share")
ARRIVAL_CHUNK, ARRIVAL_CHUNKS, ARRIVAL_TAIL = 8, 5, 3
ARRIVAL_WINDOW = 240      # frames of each timed pass: 30 whole chunks


def _busy_s(fn) -> tuple:
    """(fn(), the seconds in which the device ran anything: the union of
    the intervals of its operations in a device-only profiler pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA")
                   and not e.is_user_annotation() and e.duration_ns() > 0)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return out, busy / 1e9


def phase_replay_on_arrival(source, args, dev) -> dict:
    """Phase 27: `ChunkedOdometry` as the benchmark drives it.  Pageable
    host frames handed from one buffer the caller rewrites after each call
    give `odometry_scan`'s poses and flags on the same frames
    (np.array_equal); under sync debug "warn" a call that returns no chunk
    makes no synchronising call and one that completes a chunk (or the
    tail's flush) makes two, the chunk's fetches; no staging wait.  Then
    frames/s of a closed loop over the sequence's frames, and the device's
    idle share: 1 - (device-busy s a frame in a traced pass) / (wall s a
    frame of the untraced pass)."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import TrackingConfig
    from jetracer_orbslam2_torch.models import odometry as odo

    fcfg, tcfg = run._frontend_cfg(args, source.hw, source.cal), TrackingConfig()
    frames = [source.load(i)[:2] for i in range(source.n)]
    gray = torch.stack([f[0] for f in frames]).cpu()     # pageable host
    depth = torch.stack([f[1] for f in frames]).cpu()
    n = 1 + ARRIVAL_CHUNK * ARRIVAL_CHUNKS + ARRIVAL_TAIL
    # the reference first: a configuration not yet cached captures there
    st = odo.init_state(gray[0], depth[0], source.intr, fcfg, tcfg, device=dev)
    _, poses, ok = odo.odometry_scan(st, gray[1:n], depth[1:n], source.intr,
                                     fcfg, tcfg)
    poses, ok = poses.cpu().numpy(), ok.cpu().numpy()

    buf_g, buf_d = torch.empty_like(gray[0]), torch.empty_like(depth[0])
    ch = odo.ChunkedOdometry(source.intr, fcfg, tcfg, chunk_size=ARRIVAL_CHUNK,
                             device=dev)
    waits = {False: [], True: []}           # by "the call returns a chunk"
    for i in range(n):
        buf_g.copy_(gray[i])
        buf_d.copy_(depth[i])
        _, k = _count_waits(lambda: ch.process_frame(buf_g, buf_d))
        waits[i > 0 and i % ARRIVAL_CHUNK == 0].append(k)
        buf_g.fill_(-1.0)                   # the caller's next use of it
        buf_d.fill_(0.0)
    _, k = _count_waits(ch.flush)
    waits[True].append(k)
    got, got_ok = ch.result()
    report = {"frames": n, "waits_no_chunk": sorted(set(waits[False])),
              "waits_chunk": sorted(set(waits[True])),
              "staging_waits": ch.staging_waits,
              "frames_replayed_on_arrival": ch.frames_replayed_on_arrival,
              "equal": bool(np.array_equal(got[1:], poses)
                            and np.array_equal(got_ok[1:], ok))}
    say(f"  {n} frames: np.array_equal to odometry_scan {report['equal']}; "
        f"host waits a call returning no chunk {report['waits_no_chunk']}, "
        f"a chunk (and the tail's flush) {report['waits_chunk']}; staging "
        f"waits {ch.staging_waits}; frames replayed on arrival "
        f"{ch.frames_replayed_on_arrival}")
    bad = []
    if not report["equal"]:
        bad.append("poses or flags differ from odometry_scan")
    if report["waits_no_chunk"] != [0] or report["waits_chunk"] != [2]:
        bad.append("host waits a call")
    if ch.staging_waits or ch.frames_replayed_on_arrival != n - 1:
        bad.append("the counters")

    def closed_loop(entry, start: int, frames: int) -> float:
        """Wall s of `frames` frames handed as the benchmark hands them (a
        chunk's last call returns after its fetches)."""
        t0 = time.perf_counter()
        for i in range(start, start + frames):
            j = i % source.n
            buf_g.copy_(gray[j])
            buf_d.copy_(depth[j])
            entry.process_frame(buf_g, buf_d)
        return time.perf_counter() - t0

    m = ARRIVAL_WINDOW
    ch = odo.ChunkedOdometry(source.intr, fcfg, tcfg, chunk_size=ARRIVAL_CHUNK,
                             device=dev)
    closed_loop(ch, 0, 1 + m)               # the bootstrap and m / 8 chunks
    wall = closed_loop(ch, 1 + m, m)
    traced_wall, busy = _busy_s(lambda: closed_loop(ch, 1 + 2 * m, m))
    report.update(fps=m / wall, ms_per_frame=1e3 * wall / m,
                  device_busy_ms_per_frame=1e3 * busy / m,
                  idle_pct=100.0 * (1.0 - busy / wall),
                  staging_waits_timed=ch.staging_waits)
    say(f"  closed loop, {m} frames of 640x480 in chunks of {ARRIVAL_CHUNK}: "
        f"{report['fps']:.1f} frames/s ({report['ms_per_frame']:.3f} ms a "
        f"frame); device busy {report['device_busy_ms_per_frame']:.3f} ms a "
        f"frame (traced pass, {1e3 * traced_wall / m:.3f} ms of wall), idle "
        f"{report['idle_pct']:.1f} %; staging waits {ch.staging_waits}")
    if bad:
        raise SystemExit("FAIL: replay on arrival: " + "; ".join(bad))
    return report


def graph_cache_summary() -> dict:
    """The cache at the end of the smoke: graphs held, hits, misses,
    captures (each a miss's: a key captures once until it is evicted),
    evictions, and the device memory reserved now and at most."""
    import torch
    from jetracer_orbslam2_torch.utils import step_graph

    info = step_graph.graph_cache_info()
    info.update(memory_reserved=torch.cuda.memory_reserved(),
                max_memory_reserved=torch.cuda.max_memory_reserved())
    say("  graph cache at the end: " + json.dumps(info))
    if info["captures"] > info["misses"]:
        raise SystemExit(f"FAIL: a key captured twice while cached: {info}")
    if any(k > info["size_per_device"] for k in info["held"].values()):
        raise SystemExit(f"FAIL: the cache holds more than its bound: {info}")
    return info


# K8's payloads in the keyframe body at the window's P 8 and the map's
# 16,384 landmarks: the cost; an LM iteration's four pose-sized partials in
# one buffer (Hpp (P, 6, 6), Gh G^T (6P x 6P), bp and Gh bl (P, 6)), and the
# larger of them and the smallest alone; the gather of the landmark blocks
# (L x 3).  An LM iteration all-reduces the packed partials and its cost,
# the solve starts with a cost and ends with the gather
K8_PACKED = 8 * 36 + 48 * 48 + 2 * 48
K8_PAYLOADS = (("cost", 1), ("bp", 48), ("GhG", 48 * 48),
               ("packed", K8_PACKED), ("gather", 16384 * 3))
K8_PER_KEYFRAME = 10 * 2 + 1 + 1
K8_HEADLINE = "packed"


def _k8_check(mesh, dev) -> dict:
    """K8 (`fused_allreduce.peer_allreduce`) against its plain version, the
    group's all-reduce (NCCL), at the keyframe body's payloads on the mesh's
    one rank: both leave the input as it is (a sum over one rank); a
    relaunch and two replays of a captured graph torch.equal.  Then µs a
    call (CUDA events around a replayed graph of 20 calls, median of 20),
    the plain version's (CUDA events around 10 eager calls, median of 10,
    which is also the one PyTorch call that computes it) and the bound
    (`fused_allreduce.bound_seconds`: an all-reduce over one rank, in
    place, moves nothing, so 0; what a call costs there is its launch)."""
    import torch
    from jetracer_orbslam2_torch.ops import fused_allreduce

    k8, plain = fused_allreduce.peer_allreduce, fused_allreduce.peer_allreduce_reference
    rows, worst = [], 0.0
    for name, n in K8_PAYLOADS:
        x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(n),
                        device=dev)
        got, again, want = x.clone(), x.clone(), x.clone()
        k8(got, mesh.peers)
        k8(again, mesh.peers)
        plain(want)
        buf = torch.empty_like(x)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            buf.copy_(x)
            k8(buf, mesh.peers)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            buf.copy_(x)
            k8(buf, mesh.peers)
        replays = []
        for _ in range(2):
            graph.replay()
            replays.append(buf.clone())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        same = (torch.equal(got, want) and torch.equal(got, again)
                and all(torch.equal(r, got) for r in replays))
        work = x.clone()
        ms = time_launches(lambda: k8(work, mesh.peers), 20, 20)
        plain_ms = _median_event_ms(
            lambda: [plain(work) for _ in range(10)], 10, 10)
        bound_ms = fused_allreduce.bound_seconds(n, mesh.size) * 1e3
        row = {"payload": name, "floats": n, "max_abs_err": err,
               "equal": same, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes"}
        rows.append(row)
        say("  K8 " + json.dumps(row))
        if not same:
            raise SystemExit(f"FAIL: K8 at {name} ({n} floats): {row}")
    head = next(r for r in rows if r["payload"] == K8_HEADLINE)
    return {**{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "max_abs_err": worst, "payloads": rows}


# K8 across processes on the one card: three ranks (with two, a + b = b + a
# and no order shows), the body's payloads and every launch shape the
# wrapper picks (`fused_allreduce.launch_blocks`): one block, many, a tail
# that is not a multiple of 4 floats, a tensor that is not 16-byte aligned
# (the scalar path) and one past the receive area (two chunks); against the
# group's all-reduce (gloo sums in its own order) within K8_RANK_RTOL of
# the sum of the inputs' magnitudes.  Then the lockstep stress: K8_STRESS
# calls back to back over K8_STRESS_SIZES in turn, the last rank started
# K8_STRESS_LATE_S late, every output torch.equal to the rank-order sum
# (what a race on the receive area's parity copies would break).
K8_RANKS = 3
K8_RANK_PAYLOADS = K8_PAYLOADS + (
    ("tail_4099", 4099), ("unaligned_4099", 4099), ("full_chunk", 65536),
    ("two_chunks", 2 * 65536 + 7))
K8_RANK_RTOL = 1e-6
K8_RANK_REPLAYS = 2
K8_STRESS = 1000
K8_STRESS_SIZES = (1, K8_PACKED, 4099, 16384 * 3, 7, 2 * 65536 + 7)
K8_STRESS_LATE_S = 2.0


def _k8_rank_inputs(n: int, world: int, dev, unaligned=False) -> tuple:
    """Every rank's input of n floats from its seed, the rank-order sum and
    the sum of the magnitudes; unaligned: views one float into a buffer, so
    no pointer is 16-byte aligned."""
    import torch

    xs = []
    for r in range(world):
        x = torch.randn(n, generator=torch.Generator().manual_seed(97 * n + r))
        xs.append(torch.cat([x.new_zeros(1), x]).to(dev)[1:] if unaligned
                  else x.to(dev))
    want = xs[0].clone()
    for x in xs[1:]:
        want = want + x                 # rank order, f32
    return xs, want, torch.stack(xs).abs().sum(0)


def k8_rank(store: str, world: int, rank: int) -> int:
    """One rank of phase 25 (d)'s K8 check across processes (`chip_smoke.py
    --k8-rank STORE WORLD RANK`, started by `_k8_ranks`): joins a gloo group
    over the file store on cuda:0, maps the ranks' buffers
    (`fused_allreduce.map_peers`), and at every payload runs K8 twice on
    this rank's input, the group's all-reduce once, and a captured graph of
    K8 (warmed up once) replayed twice; then the lockstep stress.  Every
    rank makes every rank's input from its seed, so each holds K8 against
    the rank-order sum itself.  Prints one JSON line."""
    import datetime
    import hashlib

    import torch
    import torch.distributed as dist
    from jetracer_orbslam2_torch.ops import fused_allreduce

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=5))
    k8 = fused_allreduce.peer_allreduce
    rows, digest = [], hashlib.sha256()

    def fresh(x):
        """A copy of x with x's alignment (a view one float in, if x is)."""
        if x.data_ptr() % 16 == 0:
            return x.clone()
        return torch.cat([x.new_zeros(1), x])[1:]

    try:
        peers = fused_allreduce.map_peers(rank, world, dev)
        if peers is None:
            raise SystemExit("FAIL: map_peers gave no buffers on one host")
        k8.launches = 0
        for name, n in K8_RANK_PAYLOADS:
            xs, want, scale = _k8_rank_inputs(n, world, dev,
                                              name.startswith("unaligned"))
            got, again, plain = (fresh(xs[rank]) for _ in range(3))
            k8(got, peers)
            k8(again, peers)
            dist.all_reduce(plain)
            buf = fresh(xs[rank])
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                buf.copy_(xs[rank])
                k8(buf, peers)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                buf.copy_(xs[rank])
                k8(buf, peers)
            replays = []
            for _ in range(K8_RANK_REPLAYS):
                graph.replay()
                replays.append(buf.clone())
            del graph
            rel = float(((got - plain).abs() / scale).max())
            row = {"payload": name, "floats": n,
                   "blocks": fused_allreduce.launch_blocks(n, world),
                   "aligned": got.data_ptr() % 16 == 0,
                   "equals_rank_order_sum": bool(torch.equal(got, want)),
                   "relaunch_equal": bool(torch.equal(again, got)),
                   "replays_equal": all(bool(torch.equal(r, got))
                                        for r in replays),
                   "max_abs_err_vs_plain": float((got - plain).abs().max()),
                   "max_rel_err_vs_plain": rel,
                   "plain_equals_rank_order_sum": bool(torch.equal(plain, want))}
            rows.append(row)
            digest.update(got.cpu().numpy().tobytes())
        launches = k8.launches
        # the lockstep stress: the last rank starts late, then every rank
        # queues its calls back to back with no wait between them
        cases = [_k8_rank_inputs(n, world, dev) for n in K8_STRESS_SIZES]
        torch.cuda.synchronize()
        dist.barrier()
        if rank == world - 1:
            time.sleep(K8_STRESS_LATE_S)
        t0 = time.perf_counter()
        outs = []
        for i in range(K8_STRESS):
            xs, _, _ = cases[i % len(cases)]
            out = xs[rank].clone()
            k8(out, peers)
            outs.append(out)
        torch.cuda.synchronize()
        stress_s = time.perf_counter() - t0
        stress_bad = [i for i, out in enumerate(outs)
                      if not torch.equal(out, cases[i % len(cases)][1])]
        stress_launches = k8.launches - launches
        torch.cuda.synchronize()
        peers.close()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": rank, "world": world, "launches": launches,
                      "digest": digest.hexdigest(), "payloads": rows,
                      "stress": {"calls": K8_STRESS, "sizes": K8_STRESS_SIZES,
                                 "late_rank": world - 1,
                                 "late_s": K8_STRESS_LATE_S,
                                 "launches": stress_launches,
                                 "not_equal": stress_bad[:20],
                                 "n_not_equal": len(stress_bad),
                                 "seconds": stress_s}}),
          flush=True)
    return 0


def _k8_ranks() -> dict:
    """K8 across K8_RANKS processes on the one card (`k8_rank`): every rank
    torch.equal to the rank-order sum at every payload and launch shape,
    relaunch and replays too, within K8_RANK_RTOL of the group's
    all-reduce, the ranks' outputs bit-identical, 3 eager launches a
    payload on each rank (two calls and the graph's warm-up; a replay of a
    graph captured here counts none); one block, several and MAX_BLOCKS
    among the shapes; then the lockstep stress, every output torch.equal."""
    import os
    import shutil
    import tempfile

    from jetracer_orbslam2_torch.ops import fused_allreduce

    tmp = tempfile.mkdtemp(prefix="jetracer_k8_ranks_")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--k8-rank",
             os.path.join(tmp, "store"), str(K8_RANKS), str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(K8_RANKS)]
        outs = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise SystemExit(f"FAIL: a rank of the K8 check exited "
                                     f"{p.returncode}:\n" + e[-3000:])
                outs.append(json.loads(o.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = []
    want_launches = 3 * len(K8_RANK_PAYLOADS)
    for o in outs:
        for row in o["payloads"]:
            if not (row["equals_rank_order_sum"] and row["relaunch_equal"]
                    and row["replays_equal"]
                    and row["max_rel_err_vs_plain"] <= K8_RANK_RTOL):
                bad.append(f"rank {o['rank']}: {row}")
        if o["launches"] != want_launches:
            bad.append(f"rank {o['rank']}: {o['launches']} launches, "
                       f"{want_launches} expected")
        st = o["stress"]
        if st["n_not_equal"] or st["launches"] != K8_STRESS:
            bad.append(f"rank {o['rank']}'s lockstep stress: {st}")
    shapes = {(r["blocks"], r["aligned"]) for r in outs[0]["payloads"]}
    blocks = {b for b, _ in shapes}
    if not ({1, fused_allreduce.MAX_BLOCKS} <= blocks and len(blocks) > 2
            and any(not a for _, a in shapes)):
        bad.append(f"launch shapes {sorted(shapes)}: one block, several, "
                   f"{fused_allreduce.MAX_BLOCKS} and an unaligned tensor "
                   f"expected")
    same = len({o["digest"] for o in outs}) == 1
    if not same:
        bad.append("the ranks' sums differ")
    report = {
        "ranks": K8_RANKS, "backend": "gloo", "ranks_bit_identical": same,
        "launches": [o["launches"] for o in outs],
        "replays_a_payload": K8_RANK_REPLAYS,
        "launch_shapes": {r["payload"]: [r["blocks"], r["aligned"]]
                          for r in outs[0]["payloads"]},
        "max_abs_err_vs_plain": max(r["max_abs_err_vs_plain"]
                                    for o in outs for r in o["payloads"]),
        "max_rel_err_vs_plain": max(r["max_rel_err_vs_plain"]
                                    for o in outs for r in o["payloads"]),
        "rtol": K8_RANK_RTOL,
        "plain_equals_rank_order_sum": [
            r["plain_equals_rank_order_sum"] for r in outs[0]["payloads"]],
        "stress": {"calls": K8_STRESS, "late_s": K8_STRESS_LATE_S,
                   "all_equal": all(o["stress"]["n_not_equal"] == 0
                                    for o in outs),
                   "seconds": [o["stress"]["seconds"] for o in outs]},
        "seconds": time.perf_counter() - t0}
    say("  K8 ranks: " + json.dumps(report))
    if bad:
        raise SystemExit("FAIL: K8 across ranks: " + "; ".join(bad))
    return report


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
K7_CLUSTERS = tuple(range(1, 17))  # every cluster size the wrapper can take
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


# K7's paths at a shape the wrapper gives to one of them: the kernel of
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
    with the points staged and with them read from memory (the streamed
    path, which the wrapper takes above MAX_STAGED points); each must give
    ransac_select's outputs."""
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
    times = {"clusters_us": {}, "streamed_clusters_us": {}}
    for staged, key in ((True, "clusters_us"), (False, "streamed_clusters_us")):
        for ctas in K7_CLUSTERS:
            run = forced(ctas, staged)
            if not _same(run(), want):
                raise SystemExit(f"FAIL: K7 with {ctas} block(s), points "
                                 f"{'staged' if staged else 'from memory'}, differs")
            times[key][ctas] = time_launches(run, reps=20, batch=20) * 1e3
    times["streamed_us"] = times["streamed_clusters_us"][max(K7_CLUSTERS)]
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
        (f"B 3, H {K7_VERIFY_ITERS}, K {K7_POINTS}", 3, K7_POINTS, K7_VERIFY_ITERS,
         "random", {}),
    ]
    timed = [cases[i][0] for i in (0, 1, 2, 8, 9)]
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
    for label in timed:
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
    say(f"  K7 at {cases[0][0]}, cluster sizes forced (the same outputs), "
        "points staged: "
        + ", ".join(f"{c} block(s) {v:.2f} us" for c, v in one["clusters_us"].items())
        + "; points read from memory: "
        + ", ".join(f"{c} {v:.2f}" for c, v in one["streamed_clusters_us"].items()))

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
    if argv[:1] == ["--k8-rank"] and len(argv) == 4:
        # one rank of phase 25 (d)'s K8 check, started by the script itself
        return k8_rank(argv[1], int(argv[2]), int(argv[3]))
    if argv not in ([], ["--kernels"], ["--branches"]):
        print("usage: python3 chip_smoke.py [--kernels | --branches]",
              file=sys.stderr)
        return 2
    # --kernels: build, check and time the kernels only (phases 1-3, 6, 7, 11, 16)
    kernels_only = argv == ["--kernels"]
    # --branches: the frame graph's branches and the graph cache only
    # (phases 1, 2, 25 and 26)
    branches_only = argv == ["--branches"]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port under test; absent in a directory that holds only this script
    import jetracer_orbslam2_torch
    from jetracer_orbslam2_torch.ops import (
        fused_allreduce, fused_ba, fused_fast, fused_patches, fused_polish,
        fused_ransac, fused_rigid)
    from jetracer_orbslam2_torch.utils import cuda_build, step_graph
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
               "ransac_hyp", "peer_allreduce", "graph_cond"]
    cuda_build.build_libraries(sources)
    fused_fast._launcher()
    fused_ba._launchers()
    fused_patches._library()
    fused_rigid._launchers()
    fused_polish._launcher()
    fused_ransac._launcher()
    fused_allreduce._library()
    step_graph._cond_library()
    say(f"  eight libraries built and loaded in {time.perf_counter() - t0:.2f} s "
        "(graph_cond: the frame graph's conditional nodes, no kernel of the "
        "TPU's)")
    for name in sources:
        print_build(name)

    if branches_only:
        with torch.no_grad():
            phase(25, BRANCHES_TITLE)
            _, args, source, _ = open_source(N_FRAMES, dev)
            branches = phase_branches(source, args, dev)
            phase(26, GRAPH_CACHE_TITLE)
            graph_cache = phase_graph_cache(source, args, dev)
            graph_cache["end"] = graph_cache_summary()
        say(card)
        say(json.dumps({"branches": branches, "graph_cache": graph_cache,
                        "card": card}))
        return 0

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

        phase(25, BRANCHES_TITLE)
        branches = phase_branches(source, args, dev)

        phase(26, GRAPH_CACHE_TITLE)
        graph_cache = phase_graph_cache(source, args, dev)
        graph_cache["end"] = graph_cache_summary()

        phase(27, ARRIVAL_TITLE)
        arrival = phase_replay_on_arrival(source, args, dev)
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
    k8 = branches["mesh"]["k8"]
    kernels_k8 = {
        "name": "peer_allreduce",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/peer_allreduce.cu",
        "replaces": "jetracer_orbslam2_tpu/models/backend/ba.py:394",
        "launches": slam_report["mesh"]["k8_launches"],
        "branches_launches": [r["k8_launches"]
                              for r in branches["mesh"]["runs"]],
        "max_abs_err": max(k8["max_abs_err"],
                           branches["mesh"]["k8_ranks"]["max_abs_err_vs_plain"]),
        "ms": k8["ms"],
        "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"],
        "bound_by": k8["bound_by"],
        "library_ms": k8["plain_ms"],
        "ranks_check": branches["mesh"]["k8_ranks"],
        "numbers_are": "K8 has no Pallas counterpart: it replaces, inside the "
                       "frame graph's keyframe body and in every eager "
                       "collective of a mesh on the card, the JAX package's "
                       "jax.lax.psum under shard_map (XLA's all-reduce, "
                       "models/backend/ba.py:394), where NCCL's captured "
                       "all-reduce does not instantiate (its event nodes); "
                       f"ms, plain_ms, bound_ms per call at {K8_HEADLINE} "
                       f"({K8_PACKED} floats: an LM iteration's four "
                       "pose-sized partials at P 8 in one buffer) on the "
                       "one-rank NCCL mesh, where bound_ms is 0 (an "
                       "all-reduce over one rank, in place, moves no byte; "
                       "the launch is what a call costs); the plain version is "
                       "dist.all_reduce, the one PyTorch call that computes "
                       "it (library_ms the same reading); launches are "
                       "phase 13's ChunkedSlam with the mesh (22 a "
                       "keyframe), branches_launches phase 25 (d)'s lap and "
                       "lifecycle; max_abs_err the larger of the one-rank "
                       "check's and ranks_check's (three ranks on the card "
                       "against gloo's all-reduce, within 1e-6 of the "
                       "inputs' magnitudes; torch.equal to the rank-order "
                       "sum)",
        "payloads": k8["payloads"],
    }
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
    kernels.append(kernels_k8)
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
    say(json.dumps({"branches": branches, "card": card}))
    say(json.dumps({"graph_cache": graph_cache, "card": card}))
    say(json.dumps({"replay_on_arrival": arrival, "card": card}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
