#!/usr/bin/env python3
"""Profile the PyTorch port's RGB-D odometry frame loop, its bundle
adjustment, or its SLAM loop, on the GPU.

    python3 scripts/profile_torch_odometry.py [--frames 120] [--trace out.json]
    python3 scripts/profile_torch_odometry.py --ba [--landmarks 4096]
    python3 scripts/profile_torch_odometry.py --slam
    python3 scripts/profile_torch_odometry.py --stereo

Renders a 640x480 synthetic sequence on the card, warms the loop up, then
runs `odometry_scan` (one replay of its captured step a frame) over
`--frames` frames under `torch.profiler` with the device's activities only
and prints the device-busy and idle share of that pass: device time and wall
time come from the same pass, and the untraced wall time of the same frames
stands beside them; then the same for the eager step loop (`odometry_step`
a frame), and the graph's captures and replays.  A second pass over
`--table-frames` frames traces host and device and prints the top operators
by host time and by device time.  With `--sync-debug` it first prints the
host's cost of one eager call of the FAST+NMS wrapper (a frame's one call,
and the one-level call per level shape), then, for one frame of the eager
step and one of the graphed scan, the lines of the port that make the host
wait for the device, the number of ATen ops each function issues (the
eager step's count is comparable with a frame's ops before the graph) and
the launches of each hand-written kernel, K1-K7, which are no ATen ops.

With `--ba` it profiles `bundle_adjust` instead, on the synthetic problem of 8
poses x `--landmarks` landmarks, 10 LM iterations, by the fused route (the
hand-written kernels) and by the dense route: the host waits and the ATen
ops of one call, then the wall time of an untraced call and the device-busy
and idle share of a device-traced one.
With `--slam` it profiles the SLAM loop (`slam_scan`) on the gated lap (126
frames of 240x180, 3 levels, 512 keypoints, depth noise 2 % z^2): the host
waits, the ATen ops and the K1-K7 launches of one plain frame and of one
keyframe frame, their wall time, each with the tracking step replayed from its graph and run
eagerly, then the wall time of an untraced pass over the lap and the
device-busy and idle share of a device-traced one, graphed and eager, and
the graph's captures and replays.
With `--stereo` it does the same for the stereo SLAM loop on the arc of
`chip_smoke.py` phase 18 (120 stereo pairs of 640x480, 4 levels, 1,024
keypoints, two FAST thresholds), after the host waits and ATen ops of one
`frontend_stereo` call.
Needs a CUDA device; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def is_host_wait_warning(message) -> bool:
    """True for the warning PyTorch's sync-debug mode raises at a host wait
    ("called a synchronizing CUDA operation").  Switching the mode on warns
    once itself ("Synchronization debug mode is a prototype feature ..."),
    which is no wait and must not be counted as one."""
    return "called a synchronizing" in str(message)


def report_syncs(fn, what: str = "one frame") -> None:
    """Run `fn` with `torch.cuda.set_sync_debug_mode("warn")` and print, per
    line of the port, how often it made the host wait for the device."""
    import collections
    import traceback
    import warnings

    import torch

    hits = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if not is_host_wait_warning(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if "jetracer_orbslam2_torch" in f.filename]
        # a wait outside the port's frames is named by its innermost frame
        where = port[-1] if port else stack[-1]
        hits[(where.filename.split("jetracer_orbslam2_torch/")[-1],
              where.lineno, where.line)] += 1

    old = warnings.showwarning
    warnings.showwarning = note
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = old
        warnings.resetwarnings()
    print(f"host waits in {what}: {sum(hits.values())}")
    for (fname, lineno, line), count in hits.most_common():
        print(f"  {count:3d} x {fname}:{lineno}  {line}")


_VIEW_OPS = {
    "select", "slice", "unsqueeze", "view", "reshape", "expand", "permute",
    "transpose", "as_strided", "t", "_unsafe_view", "alias", "squeeze",
    "detach", "narrow", "unbind", "diagonal", "_reshape_alias", "lift_fresh"}


def report_op_counts(fn, rows: int, what: str = "one frame") -> None:
    """Run `fn` under a dispatch mode and print how many non-view ATen ops
    each function of the port issues (each is at least one launch)."""
    import collections
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode

    by_func = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                port = [f for f in traceback.extract_stack()
                        if "jetracer_orbslam2_torch" in f.filename]
                by_func[" > ".join(
                    f"{f.filename.split('/')[-1][:-3]}.{f.name}"
                    for f in port[-2:])] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    print(f"non-view ops in {what}: {sum(by_func.values())}")
    for name, count in by_func.most_common(rows):
        print(f"  {count:5d}  {name}")


def report_kernel_launches(fn, what: str = "one frame") -> None:
    """Run `fn` and print the launches of each hand-written kernel (K1-K7)
    in it: they are no ATen ops, so `report_op_counts` does not list them (a
    replayed graph counts each of its kernel nodes once)."""
    import torch
    from jetracer_orbslam2_torch.ops import (
        fused_ba, fused_fast, fused_patches, fused_polish, fused_ransac,
        fused_rigid)

    wrappers = {"K1 fast_nms_pyramid": fused_fast.fast_nms_pyramid,
                "K2 fused_normal_schur": fused_ba.fused_normal_schur,
                "K3 fused_backsub": fused_ba.fused_backsub,
                "K4 extract_patches_fused": fused_patches.extract_patches_fused,
                "K5 rigid_fit": fused_rigid.rigid_fit,
                "K6 pose_polish": fused_polish.pose_polish,
                "K7 ransac_select": fused_ransac.ransac_select}
    before = {k: w.launches for k, w in wrappers.items()}
    fn()
    torch.cuda.synchronize()
    print(f"hand-written kernel launches in {what}: " + ", ".join(
        f"{k} {w.launches - before[k]}" for k, w in wrappers.items()))


def report_wrapper_host_cost(gray, fcfg, calls: int = 200) -> None:
    """Print what one eager call of the FAST+NMS wrapper costs on the host's
    clock (issue `calls` launches, then wait): the one call a frame makes,
    over every level at one and at two thresholds, and the one-level call
    per level shape."""
    import torch

    from jetracer_orbslam2_torch.ops import fused_fast, preprocess

    levels = [lvl.contiguous() for lvl in preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(gray), fcfg.num_levels)]
    args = (fcfg.fast_arc_length, fcfg.fast_border)
    cases = [(f"fast_nms_pyramid {len(levels)} levels x {len(thr)} thresholds",
              lambda thr=thr: fused_fast.fast_nms_pyramid(levels, thr, *args))
             for thr in ((fcfg.fast_threshold,), (fcfg.fast_threshold, 7.0))]
    cases += [(f"fast_nms_response {tuple(img.shape)}",
               lambda img=img: fused_fast.fast_nms_response(
                   img, fcfg.fast_threshold, *args)) for img in levels]
    for name, fn in cases:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / calls * 1e6
        print(f"{name}: {us:.1f} us per eager call (host clock, {calls} calls)")


def profile_ba(landmarks: int, rows: int) -> None:
    """`bundle_adjust` at 8 poses x `landmarks`, 10 LM iterations, by both
    routes: host waits and ATen ops of one call, wall time of an untraced
    call, device-busy and idle share of a device-traced one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jetracer_orbslam2_torch.config import BAConfig
    from jetracer_orbslam2_torch.models.backend.ba import bundle_adjust
    from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba

    prob, intr = make_synthetic_ba(8, landmarks, 6)
    cfg = BAConfig(iters=10)
    for fused in (True, False):
        name = "fused" if fused else "dense"

        def run():
            out = bundle_adjust(prob, intr, cfg, fused=fused)
            torch.cuda.synchronize()
            return out

        def timed():
            t0 = time.perf_counter()
            run()
            return time.perf_counter() - t0

        run()                                            # build + warm
        what = f"one bundle_adjust ({name} route, {cfg.iters} iterations)"
        report_syncs(run, what)
        report_op_counts(run, rows, what)
        plain_wall = min(timed() for _ in range(3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = timed()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
        launches = sum(e.count for e in on_device)
        print(f"bundle_adjust 8 x {landmarks}, {name} route: untraced wall "
              f"{plain_wall / cfg.iters * 1e3:.3f} ms per LM iteration (best of "
              f"3); device-traced call: wall {wall / cfg.iters * 1e3:.3f} ms, "
              f"device busy {dev_s / cfg.iters * 1e3:.3f} ms per iteration = "
              f"{dev_s / wall:.1%} of that call (idle {1 - dev_s / wall:.1%}; "
              f"{1 - dev_s / plain_wall:.1%} of the untraced wall); "
              f"{launches / cfg.iters:.0f} device kernels+copies per iteration",
              flush=True)


def profile_slam(rows: int, stereo: bool = False) -> None:
    """`slam_scan` on the gated lap (or, `stereo`, on the stereo arc of
    chip_smoke.py phase 18): waits, ops and wall time of one plain frame and
    of one keyframe frame; wall, device-busy and idle share of the whole
    sequence."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jetracer_orbslam2_torch.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_torch.io.synthetic import (
        generate_lap_sequence, generate_stereo_sequence)
    from jetracer_orbslam2_torch.models import slam as slam_mod
    from jetracer_orbslam2_torch.models import slam_scan as ss

    if stereo:
        h, w, n = 480, 640, 120
        cfg = SystemConfig(
            frontend=FrontendConfig(height=h, width=w, fast_min_threshold=7.0),
            tracking=TrackingConfig(max_depth=80.0),
            stereo=StereoConfig(baseline=0.11))
        seq = generate_stereo_sequence(n, (h, w), baseline=0.11)
        firsts, depth = seq.left, seq.right
    else:
        h, w, n, lap = 180, 240, 126, 110
        cfg = SystemConfig(
            frontend=FrontendConfig(height=h, width=w, num_levels=3,
                                    max_keypoints=512),
            tracking=TrackingConfig(match_window=16.0))
        seq = generate_lap_sequence(n, (h, w), lap_frames=lap)
        rnd = torch.from_numpy(np.random.RandomState(0).randn(
            *seq.depth.shape).astype(np.float32)).to(seq.gray.device)
        firsts, depth = seq.gray, seq.depth * (1.0 + 0.02 * seq.depth * rnd)
    intr = seq.intrinsics
    dev = intr.device
    no_imu = (None, False)
    loop_name = "stereo SLAM loop" if stereo else "SLAM loop"

    if stereo:
        from jetracer_orbslam2_torch.models.stereo import frontend_stereo

        def front():
            out = frontend_stereo(firsts[5], depth[5], intr, 0.11, cfg.frontend,
                                  min_depth=cfg.tracking.min_depth,
                                  max_depth=80.0)
            torch.cuda.synchronize()
            return out

        front()
        report_syncs(front, "one frontend_stereo call")
        report_op_counts(front, rows, "one frontend_stereo call")

    def lap_pass():
        state = ss.init_scan_state(firsts[0], depth[0], intr, cfg)
        t0 = time.perf_counter()
        final, out = ss.slam_scan(state, firsts[1:], depth[1:], intr, cfg)
        torch.cuda.synchronize()
        return final, out, time.perf_counter() - t0

    def eager_step(state):
        return functools.partial(slam_mod.tracking_step, state.generator,
                                 cfg=cfg, extract=ss.frame_extract(cfg, dev))

    def eager_pass():
        """The lap through `_step` with the eager tracking step."""
        state = ss.init_scan_state(firsts[0], depth[0], intr, cfg)
        step = eager_step(state)
        t0 = time.perf_counter()
        for i in range(1, n):
            state, _ = ss._step(state, firsts[i], depth[i], no_imu, intr, cfg,
                                None, step)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    lap_pass()                                           # build + warm
    # walk the lap once, keeping the state before one plain frame and before
    # one keyframe frame (states are never changed in place; the generator is)
    # ... and watching what the windowed BA does right after an insert, when
    # the newest landmarks have one observation each
    local_ba, unchanged = slam_mod.local_ba, []

    def watched_local_ba(m, *args, **kwargs):
        out = local_ba(m, *args, **kwargs)
        unchanged.append(torch.equal(out.kf_pose, m.kf_pose)
                         and torch.equal(out.lm_pos, m.lm_pos))
        return out

    slam_mod.local_ba = watched_local_ba
    state = ss.init_scan_state(firsts[0], depth[0], intr, cfg)
    examples = {}
    try:
        for i in range(1, n):
            gen = state.generator.get_state()
            new_state, row = ss._step(state, firsts[i], depth[i], no_imu, intr,
                                      cfg)
            kind = "keyframe frame" if row[-1] else "plain frame"
            if i > 20 and kind not in examples:
                examples[kind] = (state, i, gen)
            state = new_state
    finally:
        slam_mod.local_ba = local_ba
    print(f"local_ba right after insert_keyframe left the map unchanged (every "
          f"LM step rejected) at {sum(unchanged)} of {len(unchanged)} keyframes",
          flush=True)

    for kind, (st, i, gen) in examples.items():
        for route in ("graphed", "eager"):
            graph = st.graph if route == "graphed" else eager_step(st)

            def one():
                st.generator.set_state(gen)
                out = ss._step(st, firsts[i], depth[i], no_imu, intr, cfg,
                               None, graph)
                torch.cuda.synchronize()
                return out

            def timed():
                t0 = time.perf_counter()
                one()
                return time.perf_counter() - t0

            what = f"one {kind} of the {loop_name} (frame {i}, {route} step)"
            report_syncs(one, what)
            report_op_counts(one, rows, what)
            report_kernel_launches(one, what)
            print(f"{what}: {min(timed() for _ in range(5)) * 1e3:.2f} ms wall "
                  f"(host clock + sync, best of 5)", flush=True)

    frames = n - 1
    for route in ("graphed", "eager"):
        if route == "graphed":
            _, out, plain_wall = lap_pass()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                final, out, wall = lap_pass()
            keyframes = int(out.is_kf.sum())
            graph = (f"; its graph: {final.graph.captures} capture, "
                     f"{final.graph.replays} replays, "
                     f"{final.graph.eager_calls} eager call")
        else:
            _, plain_wall = eager_pass()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                final, wall = eager_pass()
            keyframes, graph = int(final.m.num_kf) - 1, ""
        on_device = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
        dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
        launches = sum(e.count for e in on_device)
        print(f"{loop_name}, {route} tracking step, {frames} frames of {w}x{h} "
              f"({keyframes} keyframes inserted, {int(final.num_loops)} loops): "
              f"device-traced pass wall {wall / frames * 1e3:.3f} ms/frame, "
              f"device busy {dev_s / frames * 1e3:.3f} ms/frame = "
              f"{dev_s / wall:.1%} of that pass (idle {1 - dev_s / wall:.1%}); "
              f"{launches / frames:.0f} device kernels+copies per frame; the "
              f"untraced pass before it: {plain_wall / frames * 1e3:.3f} "
              f"ms/frame = {frames / plain_wall:.1f} frames/s (idle "
              f"{1 - dev_s / plain_wall:.1%}){graph}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slam", action="store_true",
                    help="profile the SLAM loop on the gated lap instead of "
                         "the odometry frame loop")
    ap.add_argument("--stereo", action="store_true",
                    help="profile the stereo SLAM loop on chip_smoke.py phase "
                         "18's arc (120 pairs of 640x480) instead")
    ap.add_argument("--ba", action="store_true",
                    help="profile bundle_adjust (both routes) instead of the "
                         "odometry frame loop")
    ap.add_argument("--landmarks", type=int, default=4096,
                    help="landmarks of the --ba problem (8 poses)")
    ap.add_argument("--frames", type=int, default=120,
                    help="frames of the pass the idle share is taken over")
    ap.add_argument("--table-frames", type=int, default=8,
                    help="frames of the pass the operator tables are taken over")
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    ap.add_argument("--sync-debug", action="store_true",
                    help="also run one frame with torch's sync debug mode and "
                         "list the port's lines that make the host wait, and "
                         "one frame counting ATen ops per function")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jetracer_orbslam2_torch.config import FrontendConfig, TrackingConfig
    from jetracer_orbslam2_torch.io.synthetic import generate_sequence
    from jetracer_orbslam2_torch.models.odometry import (
        init_state, odometry_scan, odometry_step)
    from jetracer_orbslam2_torch.utils.device import resolve_device

    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    if args.ba or args.slam or args.stereo:
        with torch.no_grad():
            if args.ba:
                profile_ba(args.landmarks, args.rows)
            else:
                profile_slam(args.rows, stereo=args.stereo)
        return 0
    n, warm, m = args.frames, 8, args.table_frames
    seq = generate_sequence(1 + warm + n, (480, 640), device=dev)
    fcfg, tcfg = FrontendConfig(), TrackingConfig()
    state = init_state(seq.gray[0], seq.depth[0], seq.intrinsics, fcfg, tcfg)
    state, _, _ = odometry_scan(state, seq.gray[1:warm + 1], seq.depth[1:warm + 1],
                                seq.intrinsics, fcfg, tcfg)      # warm-up
    torch.cuda.synchronize()
    one = slice(warm + 1, warm + 2)

    gen_state = state.generator.get_state()

    def eager_frame():
        state.generator.set_state(gen_state)
        odometry_step(state, seq.gray[warm + 1], seq.depth[warm + 1],
                      seq.intrinsics, fcfg, tcfg)

    def graphed_frame():
        state.generator.set_state(gen_state)
        odometry_scan(state, seq.gray[one], seq.depth[one], seq.intrinsics,
                      fcfg, tcfg)

    if args.sync_debug:
        report_wrapper_host_cost(seq.gray[0], fcfg)
        for what, fn in (("one frame of the eager step (odometry_step)",
                          eager_frame),
                         ("one frame of odometry_scan (a graph replay)",
                          graphed_frame)):
            report_syncs(fn, what)
            report_op_counts(fn, args.rows, what)
            report_kernel_launches(fn, what)

    def window(frames: int, eager: bool = False):
        """The same `frames` frames from the same state (the scan replays
        the state's graph, or the eager step loop), timed on the host's
        clock up to the final synchronisation."""
        state.generator.set_state(gen_state)
        t0 = time.perf_counter()
        if eager:
            st, oks = state, []
            for i in range(warm + 1, warm + 1 + frames):
                st, res = odometry_step(st, seq.gray[i], seq.depth[i],
                                        seq.intrinsics, fcfg, tcfg)
                oks.append(res.tracked_ok)
            out = (st, None, torch.stack(oks))
        else:
            out = odometry_scan(state, seq.gray[warm + 1:warm + 1 + frames],
                                seq.depth[warm + 1:warm + 1 + frames],
                                seq.intrinsics, fcfg, tcfg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def device_events(prof):
        return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    # the idle share: device time and wall time of ONE pass, traced on the
    # device side only (tracing the host's ops as well would stretch the wall)
    for route in ("graphed", "eager"):
        eager = route == "eager"
        _, plain_wall = window(n, eager)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (final, _, ok), wall = window(n, eager)
        on_device = device_events(prof)
        dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
        launches = sum(e.count for e in on_device)
        graph = "" if eager else (
            f"; the scan's graph: {final.graph.captures} capture, "
            f"{final.graph.replays} replays, {final.graph.eager_calls} eager "
            "call over the warm-up and every pass so far")
        print(f"{n} frames, {route} step, device-traced pass: wall "
              f"{wall / n * 1e3:.3f} ms/frame, device busy "
              f"{dev_s / n * 1e3:.3f} ms/frame = {dev_s / wall:.1%} of "
              f"that pass (idle {1 - dev_s / wall:.1%}); "
              f"{launches / n:.0f} device kernels+copies per frame; "
              f"tracked {int(ok.sum())}/{n}; the untraced pass before it: "
              f"{plain_wall / n * 1e3:.3f} ms/frame, of which the same device "
              f"time is {dev_s / plain_wall:.1%} (idle "
              f"{1 - dev_s / plain_wall:.1%}) - tracing stretches the wall, "
              f"so the two idle shares bracket the loop's own{graph}",
              flush=True)

    # the operator tables: host and device activities over a few frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = window(m)
    events = prof.key_averages()
    print(f"{m} frames, host+device-traced pass: wall {wall / m * 1e3:.3f} ms/frame")
    print(events.table(sort_by="self_cpu_time_total", row_limit=args.rows,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cuda_time_total", row_limit=args.rows,
                       max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
