#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # no arguments, one GPU

Drives `jetracer_orbslam2_torch`'s paths through the functions a user calls:
RGB-D odometry on a synthetic 640x480 sequence at the CLI's defaults (4
pyramid levels, 1024 keypoints, 256 RANSAC hypotheses), standalone bundle
adjustment at 8 poses x 4,096 landmarks, windowed BA over a keyframe map at
its full capacity (256 keyframe slots, 16,384 landmarks, 65,536
observations) and the pose graph.  It builds the hand-written CUDA kernels
from the sources in this checkout, holds each against its plain PyTorch
version, shows that each path launched its kernels, and times them.

Phases (any failure ends the run with a non-zero exit; there is no CPU path):
   1 device       a CUDA device must be present; prints the card's name and
                  power limit as nvidia-smi gives them
   2 build        nvcc compiles csrc/fast_nms.cu and csrc/ba_fused.cu side by
                  side; prints seconds and ptxas' notes
   3 K1 check     fast_nms kernel vs plain version, torch.equal, every shape
   4 semantics    tie orders and CPU/GPU agreement of the front-end
   5 main path    whole-sequence odometry: ATE, tracked fraction, kernel
                  launches; --chunked 32 on the same frames gives the same
                  poses; a second, warm run is timed
   6 K1 time      median device time per launch at the four level shapes
   7 K2/K3 check  fused_normal_schur and fused_backsub vs their plain
                  versions at every listed (P, L), against a float64 truth,
                  and bit-identical between two launches
   8 BA path      bundle_adjust, 8 x 4,096, 10 iterations through the
                  kernels: trace, gauge, launches, agreement with the dense
                  route; ms per LM iteration of both routes
   9 local BA     eight keyframes of the rendered sequence inserted into a
                  full-size map, then local_ba by both routes
  10 pose graph   a drifted ring closes; a second run gives the same poses
  11 K2/K3 time   device time per launch beside the counted bound and the
                  plain version's time
Kernel times are CUDA events around a replayed CUDA graph of launches.  Then
the paths' reports, one JSON line `{"kernels": [...]}`, and as the last line
`{"ok": true, "device": {...}}`.

Imports torch and the port only: no JAX, nothing of the JAX package.
"""

from __future__ import annotations

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
N_FRAMES = 120
N_PHASES = 11

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


def fast_nms_work(img, threshold: float, border: int) -> tuple[int, int]:
    """(bytes, f32 operations) the FAST+NMS function needs on THIS image:
    each input read once and each output written once; per scored pixel 16
    subtractions and 32 compares, 2 more per ring pixel that passes +-t
    (counted from the data), and 9 compares per pixel for the 3x3 max."""
    from jetracer_orbslam2_torch.ops.fast import RING_OFFSETS

    h, w = img.shape
    b = border
    scored = max(h - 2 * b, 0) * max(w - 2 * b, 0)
    passes = 0
    if scored:
        c = img[b:h - b, b:w - b]
        for dy, dx in RING_OFFSETS:
            d = img[b + dy:h - b + dy, b + dx:w - b + dx] - c
            passes += int((d.abs() > threshold).sum())
    return 8 * h * w, scored * 48 + 2 * passes + 9 * h * w


def phase_kernel_checks(levels) -> tuple[float, bool]:
    """Kernel vs plain version, bit for bit.  Returns the max abs error seen
    and whether every comparison was torch.equal."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch.ops import fused_fast

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
    for name, img, thr, arc, border in cases:
        got = fused_fast.fast_nms_response(img, thr, arc, border)
        ref = fused_fast.fast_nms_response_reference(img, thr, arc, border)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        corners = int((ref > 0).sum())
        equal = torch.equal(got, ref)
        all_equal = all_equal and equal
        say(f"  kernel vs plain  {name:36s} corners {corners:6d}  "
            f"max_abs_err {err:g}  equal {equal}")
        if not equal:
            raise SystemExit(f"FAIL: fast_nms kernel disagrees with its plain "
                             f"version at {name}")
    for bad in (lambda: fused_fast.fast_nms_response(rnd, 7.5, 12, 2),
                lambda: fused_fast.fast_nms_response(rnd.double(), 7.5, 12, 3),
                lambda: fused_fast.fast_nms_response(rnd.T, 7.5, 12, 3)):
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
    frames, n, hw = source[:3]
    say(f"  rendered {n} frames of {hw[1]}x{hw[0]} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gray0 = next(iter(frames()))[0]
    levels = preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(gray0), args.levels)
    return argv, args, source, levels


def phase_main_path(argv, args, source, dev):
    """Whole-sequence odometry through the CLI's functions; returns the
    report, the kernel's launch count on that run and the tracked poses."""
    import numpy as np
    import torch
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.ops import fused_fast

    frames, n, hw, intr, gt = source
    fused_fast.fast_nms_response.launches = 0
    report, poses = run._run_odometry(args, frames, n, hw, intr, dev)
    launches = fused_fast.fast_nms_response.launches
    run._accuracy(report, poses, gt, n)
    say("  main path (cold): " + json.dumps(report))
    if not np.isfinite(poses).all() or poses.shape != (n, 4, 4):
        raise SystemExit("FAIL: poses are not finite (N, 4, 4)")
    if launches != args.levels * n:
        raise SystemExit(f"FAIL: fast_nms launches {launches} != {args.levels} * {n}")
    if not report["ate_rmse_m"] < 0.10:
        raise SystemExit(f"FAIL: ATE RMSE {report['ate_rmse_m']} m >= 0.10 m")
    if not report["tracked_frac"] >= 0.95:
        raise SystemExit(f"FAIL: tracked_frac {report['tracked_frac']} < 0.95")

    # constant-memory streaming on the same frames: the same poses
    chunk_args = run.build_argparser().parse_args(argv + ["--chunked", "32"])
    c_report, c_poses = run._run_odometry(chunk_args, frames, n, hw, intr, dev)
    say("  main path (--chunked 32): " + json.dumps(c_report))
    if not np.array_equal(c_poses, poses):
        raise SystemExit("FAIL: --chunked 32 poses differ from the whole scan "
                         f"(max abs diff {np.abs(c_poses - poses).max():g})")

    # warm run, timed on the device's clock with one final synchronisation
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    w_report, w_poses = run._run_odometry(args, frames, n, hw, intr, dev)
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


def phase_kernel_times(levels) -> dict:
    """Per level shape: kernel ms, plain ms, bound ms; and their means over
    the four launches a frame makes."""
    from jetracer_orbslam2_torch.ops import fused_fast

    shapes = []
    for lvl in levels:
        img = lvl.contiguous()
        n_bytes, n_ops = fast_nms_work(img, FAST_THRESHOLD, FAST_BORDER)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        before = fused_fast.fast_nms_response.launches
        ms = time_launches(lambda: fused_fast.fast_nms_response(
            img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=20)
        assert fused_fast.fast_nms_response.launches > before
        plain_ms = time_launches(
            lambda: fused_fast.fast_nms_response_reference(
                img, FAST_THRESHOLD, FAST_ARC, FAST_BORDER), reps=20, batch=2)
        row = {"shape": list(img.shape), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": n_bytes, "operations": n_ops}
        shapes.append(row)
        say(f"  fast_nms {tuple(img.shape)}: kernel {ms:.5f} ms on the card, "
            f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}: {n_bytes} B, {n_ops} f32 ops)")
    k = len(shapes)
    bytes_ms = sum(s["bytes"] for s in shapes) / HBM_BYTES_PER_S * 1e3 / k
    ops_ms = sum(s["operations"] for s in shapes) / F32_OPS_PER_S * 1e3 / k
    return {
        # means per launch over the launches one frame makes (one per level)
        "ms": sum(s["ms"] for s in shapes) / k,
        "plain_ms": sum(s["plain_ms"] for s in shapes) / k,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "shapes": shapes,
    }


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

    frames, n, hw, intr, _ = source
    fcfg = FrontendConfig(height=hw[0], width=hw[1], num_levels=args.levels,
                          max_keypoints=args.max_keypoints,
                          fast_min_threshold=args.fast_min_threshold)
    cfg = SystemConfig(frontend=fcfg)
    W = cfg.map.window_size
    m = map_mod.init_map(cfg.map, fcfg.max_keypoints)
    frame_list = list(frames())
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
    }


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


def phase_ba_kernel_times(dev) -> dict:
    """K2 and K3 at (8, 4096) and (8, 16384): device ms per launch, the plain
    version's, and the bound counted from the inputs."""
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
            ms = time_launches(lambda: fn(*args_), reps=20, batch=20)
            assert fn.launches > before
            plain_ms = time_launches(lambda: ref(*args_), reps=10, batch=2)
            n_bytes, n_ops = work[name]
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / F32_OPS_PER_S * 1e3
            row = {"shape": [8, L], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "bytes": n_bytes, "operations": n_ops}
            out[name].append(row)
            say(f"  {name} (P 8, L {L}): kernel {ms:.5f} ms on the card, plain "
                f"{plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
                f"({row['bound_by']}: {n_bytes} B, {n_ops} f32 ops)")
    return out


def print_build(name: str) -> None:
    from jetracer_orbslam2_torch.utils import cuda_build

    info = cuda_build.build_info[name]
    say(f"  nvcc built csrc/{name}.cu in {info['seconds']:.2f} s -> "
        f"{cuda_build.library_path(name).name}")
    for line in info["log"].splitlines():
        say("    " + line)


def main() -> int:
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port under test; absent in a directory that holds only this script
    import jetracer_orbslam2_torch
    from jetracer_orbslam2_torch.ops import fused_ba, fused_fast
    from jetracer_orbslam2_torch.utils import cuda_build
    from jetracer_orbslam2_torch.utils.device import resolve_device
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    phase = lambda k, text: say(f"[{k}/{N_PHASES}] {text}")  # noqa: E731
    phase(1, "device")
    card = card_line()
    say(card)
    dev = resolve_device(None)
    set_exact_f32()
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, port {jetracer_orbslam2_torch.__version__}")

    phase(2, "build (one nvcc per source, started together)")
    t0 = time.perf_counter()
    cuda_build.build_libraries(["fast_nms", "ba_fused"])
    fused_fast._launcher()
    fused_ba._launchers()
    say(f"  both libraries built and loaded in {time.perf_counter() - t0:.2f} s")
    print_build("fast_nms")
    print_build("ba_fused")

    with torch.no_grad():
        phase(3, "fast_nms kernel vs its plain version (torch.equal)")
        argv_run, args, source, levels = open_source(N_FRAMES, dev)
        max_err, all_equal = phase_kernel_checks(levels)

        phase(4, "device semantics")
        phase_semantics(dev)

        phase(5, f"main path: {N_FRAMES} frames of 640x480, 4 levels, K=1024")
        report, launches, poses = phase_main_path(argv_run, args, source, dev)

        phase(6, "fast_nms times (CUDA events around a replayed CUDA graph of 20 "
                 "launches, median of 20; the image is L2-warm, as the front-end "
                 "leaves it)")
        times = phase_kernel_times(levels)

        phase(7, "fused_normal_schur (K2) and fused_backsub (K3) vs their plain "
                 "versions; errors relative to each output's scale, against the "
                 f"plain version in float64; tol = {TOL_FACTOR:g} x plain err + "
                 f"{TOL_FLOOR:g}")
        worst = phase_ba_kernel_checks(dev)

        phase(8, f"BA path: bundle_adjust, {BA_POSES} poses x {BA_LANDMARKS} "
                 f"landmarks, {BA_ITERS} LM iterations")
        ba_report = phase_ba_path(dev)

        phase(9, f"local BA: {KF_COUNT} keyframes (every {KF_EVERY}th frame) in a "
                 "map of full capacity")
        local_report = phase_local_ba(args, source, poses, dev)

        phase(10, "pose graph")
        pg_report = phase_pose_graph(dev)

        phase(11, "K2/K3 times (CUDA events around a replayed CUDA graph of 20 "
                  "launches, median of 20; inputs L2-warm, as the LM loop leaves "
                  "them)")
        ba_times = phase_ba_kernel_times(dev)
    torch.cuda.synchronize()

    kernels = [{
        "name": "fast_nms_response",
        "route": "cuda",
        "source": "jetracer_orbslam2_torch/csrc/fast_nms.cu",
        "replaces": "jetracer_orbslam2_tpu/ops/pallas_fast.py:190",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
        "exact_match": all_equal,
        "numbers_are": "means per launch over the four level shapes of a frame",
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
            "launches": count,
            "max_abs_err": worst[key]["abs"],
            "max_abs_err_scale": worst[key]["scale"],
            "max_abs_err_where": worst[key]["where"],
            "ms": at_path["ms"],
            "plain_ms": at_path["plain_ms"],
            "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"],
            "library_ms": None,
            "numbers_are": "per launch at (P 8, L 4096), the BA path's shape; "
                           "launches are the BA path's (local BA launched "
                           f"{local_report['launches']} more)",
            "shapes": ba_times[name],
        })
    seconds = round(time.perf_counter() - t_start, 1)
    say(json.dumps({"main_path": report, "card": card, "seconds": seconds}))
    say(json.dumps({"ba_path": ba_report, "local_ba": local_report,
                    "pose_graph": pg_report, "card": card}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
