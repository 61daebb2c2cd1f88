"""The yardstick's own arithmetic: the K1 byte count, the frozen renderer
and the plain front-end against the port's at small shapes on the CPU, and
the trajectory alignment."""

import numpy as np
import pytest
import torch

from slambench.harness import work
from slambench.reference import frontend, render, trajectory


def test_k1_bytes_at_640x480_four_levels_one_threshold():
    assert work.k1_bytes(480, 640, 4, images=1, thresholds=1) == 3_264_000
    assert work.k1_bytes(480, 640, 4, images=1, thresholds=2) == 4_896_000
    assert work.k1_bytes(480, 640, 4, images=2, thresholds=2) == 9_792_000
    assert work.k1_bytes(480, 752, 4, images=2, thresholds=1) == 7_670_400


def test_k1_bytes_of_the_configurations():
    from slambench.harness import spec

    assert work.k1_bytes_of(spec.read_json("configs", "tum-rgbd-640x480")) == 3_264_000
    assert work.k1_bytes_of(spec.read_json("configs", "euroc-stereo-752x480")) == 7_670_400


def test_peaks_table():
    assert work.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert work.peaks("a device nobody listed") is None


def test_frozen_renderer_matches_the_ports():
    from jetracer_orbslam2_torch.io import synthetic

    tex_np = render.make_textures(7)
    np.testing.assert_array_equal(tex_np, synthetic.make_textures(7))
    tex = torch.from_numpy(tex_np)
    poses = render.lap_trajectory(12, 1.0, 2.0, 12)
    torch.testing.assert_close(
        poses, synthetic.lap_trajectory(12, radius=1.0, center_z=2.0,
                                        lap_frames=12), rtol=0, atol=0)
    intr = torch.tensor([54.0, 54.0, 29.5, 19.5])
    for i in (0, 5):
        got = render.render_frame(poses[i], intr, tex, (40, 60))
        want = synthetic.render_frame(poses[i], intr, tex, (40, 60))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _frame(stereo=False):
    tex = torch.from_numpy(render.make_textures(3))
    intr = torch.tensor([144.0, 144.0, 79.5, 59.5])
    pose = render.lap_trajectory(8, 1.0, 2.0, 80)[3]
    gray, depth = render.render_frame(pose, intr, tex, (120, 160))
    if stereo:
        shift = torch.eye(4)
        shift[0, 3] = 0.11
        right, _ = render.render_frame(pose @ shift, intr, tex, (120, 160))
        return gray, right, intr
    return gray, depth, intr


FE = dict(height=120, width=160, num_levels=2, cell_size=16, max_keypoints=256,
          fast_threshold=13.0, fast_min_threshold=0.0, fast_arc_length=12,
          fast_border=19, patch_size=37, num_angle_bins=32, descriptor_bits=256,
          min_score=1e-3)


@pytest.mark.parametrize("min_threshold", [0.0, 7.0])
def test_plain_frontend_matches_the_ports_rgbd(min_threshold):
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth

    fe = dict(FE, fast_min_threshold=min_threshold)
    gray, depth, intr = _frame()
    ref = frontend.features_rgbd(gray, depth, intr, fe, 0.05, 8.0)
    got = frontend_gray_depth(gray, depth, intr, FrontendConfig(**fe),
                              min_depth=0.05, max_depth=8.0, device="cpu")
    assert int(ref["valid"].sum()) > 50
    for name in ("xy", "level", "valid", "desc", "has_point", "points"):
        assert torch.equal(ref[name], getattr(got, name)), name


def test_plain_frontend_matches_the_ports_stereo():
    from jetracer_orbslam2_torch.config import FrontendConfig
    from jetracer_orbslam2_torch.models.stereo import frontend_stereo

    left, right, intr = _frame(stereo=True)
    st = {"baseline": 0.11, "max_disparity": 128.0, "epipolar_tol": 2.0,
          "max_hamming": 48}
    ref = frontend.features_stereo(left, right, intr, FE, st, 0.05, 80.0)
    got = frontend_stereo(left, right, intr, 0.11, FrontendConfig(**FE),
                          min_depth=0.05, max_depth=80.0, device="cpu")
    assert int(ref["has_point"].sum()) > 20
    for name in ("xy", "level", "valid", "desc", "has_point", "points"):
        assert torch.equal(ref[name], getattr(got, name)), name


def test_bfloat16_pixels_change_the_features():
    """The control's precision moves keypoints and descriptor bits."""
    gray, depth, intr = _frame()
    ref = frontend.features_rgbd(gray, depth, intr, FE, 0.05, 8.0)
    low = frontend.features_rgbd(gray, depth, intr, FE, 0.05, 8.0,
                                 pixel_dtype=torch.bfloat16)
    assert not torch.equal(ref["xy"], low["xy"])


def test_alignment_matches_the_ports_ate():
    from jetracer_orbslam2_torch.evaluation import ate

    gen = torch.Generator().manual_seed(0)
    gt = render.lap_trajectory(40, 1.0, 2.0, 40).double()
    R = render.so3_exp(torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64))
    est = gt.clone()
    est[:, :3, :3] = R @ gt[:, :3, :3]
    est[:, :3, 3] = (gt[:, :3, 3] @ R.T + torch.tensor([0.5, -0.1, 0.2],
                                                        dtype=torch.float64)
                     + 0.01 * torch.randn(40, 3, generator=gen,
                                          dtype=torch.float64))
    err = trajectory.position_errors(est.numpy(), gt.numpy())
    want = ate(est, gt)
    assert trajectory.rmse(err) == pytest.approx(float(want.rmse), rel=1e-9)
    assert float(err.max()) == pytest.approx(float(want.max), rel=1e-9)
