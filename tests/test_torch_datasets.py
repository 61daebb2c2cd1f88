"""The port's dataset ingestion vs the JAX package (CPU): the TUM RGB-D, EuRoC
and KITTI loaders on the committed fixtures, stereo rectification, the native
PNG decoder against PIL, `align_depth_to_color`, the front-end on an
unregistered depth camera, and `distort_pixels`."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.io import datasets as jds
from jetracer_orbslam2_tpu.models.frontend import frontend_gray_depth as j_frontend
from jetracer_orbslam2_tpu.ops import align as jalign
from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.config import FrontendConfig
from jetracer_orbslam2_torch.convert import features_to_numpy
from jetracer_orbslam2_torch.io import datasets as tds
from jetracer_orbslam2_torch.io import native_loader
from jetracer_orbslam2_torch.models.frontend import frontend_gray_depth
from jetracer_orbslam2_torch.ops import align as talign
from jetracer_orbslam2_torch.ops import geometry as tgeo

from _torch_port_util import jax_features_to_numpy, n, t

close = np.testing.assert_allclose

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = {
    "tum_tiny": os.path.join(FIX, "tum_tiny"),
    "tum_tiny_unaligned": os.path.join(FIX, "tum_tiny_unaligned"),
    "euroc_tiny": os.path.join(FIX, "euroc_tiny", "mav0"),
    "euroc_tiny_dist": os.path.join(FIX, "euroc_tiny_dist", "mav0"),
    "kitti_tiny": os.path.join(FIX, "kitti_tiny"),
}
CAL_FIELDS = ("dist", "dist_model", "dist_r", "rect_l", "rect_r",
              "intrinsics_r", "depth_intrinsics", "depth_dist",
              "T_color_depth")


def _equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, str):
        assert a == b, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loader_matches_jax_on_fixture(name):
    ref = jds.open_dataset(FIXTURES[name])
    got = tds.open_dataset(FIXTURES[name])
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) >= 16
    _equal(got.intrinsics, ref.intrinsics, "intrinsics")
    assert got.baseline == ref.baseline
    _equal(got.groundtruth, ref.groundtruth, "groundtruth")
    for field in CAL_FIELDS:
        _equal(getattr(got, field, None), getattr(ref, field, None), field)
    pk_ref = getattr(ref, "imu_packets", lambda: None)()
    pk_got = getattr(got, "imu_packets", lambda: None)()
    assert (pk_ref is None) == (pk_got is None)
    if pk_ref is not None:
        for a, b in zip(pk_got, pk_ref):
            _equal(a, b, "imu_packets")
    for i in range(len(ref)):
        fr, fg = ref.frame(i), got.frame(i)
        for field in ("gray", "depth", "right"):
            _equal(getattr(fg, field), getattr(fr, field), f"frame {i} {field}")
        assert fg.timestamp == fr.timestamp and fg.index == fr.index == i


def test_stereo_rectify_rotations_and_unknown_layout(tmp_path):
    rng = np.random.RandomState(3)
    for _ in range(5):
        R = jds._rodrigues_exp(rng.uniform(-0.05, 0.05, 3))
        t_ = np.asarray([-0.11, 0.0, 0.0]) + rng.uniform(-0.01, 0.01, 3)
        for a, b in zip(tds.stereo_rectify_rotations(R, t_),
                        jds.stereo_rectify_rotations(R, t_)):
            _equal(a, b, "rectification")
    args = (np.arange(40) * 0.01 + 0.005, rng.randn(40, 3).astype(np.float32),
            rng.randn(40, 3).astype(np.float32), np.arange(5) * 0.1)
    for a, b in zip(tds.build_imu_packets(*args, max_samples=4),
                    jds.build_imu_packets(*args, max_samples=4)):
        _equal(a, b, "imu packets")
    with pytest.raises(ValueError, match="unrecognized dataset layout"):
        tds.open_dataset(str(tmp_path))


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    if arr.dtype == np.uint16:
        Image.fromarray(arr, mode="I;16").save(buf, format="PNG")
    else:
        Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8),          # gray 8  (odd sizes exercise filters)
    ((64, 64), np.uint16),         # gray 16 (TUM depth)
    ((40, 60, 3), np.uint8),       # RGB
    ((24, 31, 4), np.uint8),       # RGBA
])
def test_native_decoder_matches_pil(shape, dtype):
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.library_path().parent.name == "_build"
    rng = np.random.default_rng(sum(shape))
    hi = 65535 if dtype == np.uint16 else 255
    base = rng.integers(0, hi, shape).astype(np.int64)
    yy = np.arange(shape[0])[:, None] * (hi // max(shape[0], 1))
    grad = yy + np.arange(shape[1])[None, :]
    if len(shape) == 3:
        grad = grad[..., None]
    arr = ((base + grad) % (hi + 1)).astype(dtype)
    np.testing.assert_array_equal(native_loader.decode_png(_png_bytes(arr)), arr)
    with pytest.raises(ValueError):
        native_loader.decode_png(b"not a png at all")


def test_native_frame_loader_in_order_and_skips_bad_files(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths, imgs = [], []
    for i in range(12):
        arr = rng.integers(0, 255, (32, 48), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
        imgs.append(arr)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    paths.insert(3, bad)
    paths.insert(7, str(tmp_path / "missing.png"))
    ld = native_loader.NativeFrameLoader(paths, threads=3, capacity=4)
    got = list(ld)
    ld.close()
    assert ld.num_errors == 2
    assert len(got) == 12
    for k, (_, arr) in enumerate(got):
        np.testing.assert_array_equal(arr, imgs[k])


def test_decoders_agree_and_the_native_one_can_be_disabled(tmp_path, monkeypatch):
    """The readers give the same frames through the native decoder and
    through PIL; JETRACER_DISABLE_NATIVE=1 routes every read to PIL."""
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    dep = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
    rgb_p, dep_p = str(tmp_path / "rgb.png"), str(tmp_path / "dep.png")
    Image.fromarray(rgb).save(rgb_p)
    Image.fromarray(dep, mode="I;16").save(dep_p)

    before = dict(tds.DECODED)
    g_native = tds._imread_rgb_as_gray(rgb_p)
    d_native = tds._imread_depth16(dep_p, 1 / 5000.0)
    assert tds.DECODED["native"] == before["native"] + 2
    monkeypatch.setenv("JETRACER_DISABLE_NATIVE", "1")
    assert not native_loader.available()
    g_pil = tds._imread_rgb_as_gray(rgb_p)
    d_pil = tds._imread_depth16(dep_p, 1 / 5000.0)
    assert tds.DECODED["pil"] == before["pil"] + 2
    np.testing.assert_array_equal(g_native, g_pil)
    np.testing.assert_array_equal(d_native, d_pil)
    # and the JAX package's readers give the same
    np.testing.assert_array_equal(jds._imread_rgb_as_gray(rgb_p), g_pil)
    np.testing.assert_array_equal(jds._imread_depth16(dep_p, 1 / 5000.0), d_pil)


@pytest.fixture(scope="module")
def unaligned():
    return tds.open_dataset(FIXTURES["tum_tiny_unaligned"])


def test_align_depth_to_color_matches_jax(unaligned):
    """On the fixture's calibration, every pixel of every frame is equal (the
    same f32 expressions in the same order, rounded half to even)."""
    ds = unaligned
    T = np.asarray(ds.T_color_depth, np.float32).reshape(4, 4)
    di = np.asarray(ds.depth_intrinsics, np.float32)
    covered = []
    for i in range(0, len(ds), 5):
        raw = ds.frame(i).depth
        ref = np.asarray(jalign.align_depth_to_color(
            jnp.asarray(raw), jnp.asarray(di), jnp.asarray(ds.intrinsics),
            jnp.asarray(T), raw.shape))
        got = n(talign.align_depth_to_color(
            t(raw), t(di), t(ds.intrinsics), t(T), raw.shape, device="cpu"))
        np.testing.assert_array_equal(got, ref)
        covered.append((got > 0).mean())
    assert min(covered) > 0.8
    # with lens distortion on both cameras
    dist = np.float32([0.05, -0.01, 1e-3, -1e-3, 0.0])
    ref = np.asarray(jalign.align_depth_to_color(
        jnp.asarray(raw), jnp.asarray(di), jnp.asarray(ds.intrinsics),
        jnp.asarray(T), raw.shape, jnp.asarray(dist), jnp.asarray(-dist)))
    got = n(talign.align_depth_to_color(
        t(raw), t(di), t(ds.intrinsics), t(T), raw.shape, t(dist), t(-dist),
        device="cpu"))
    assert (got == ref).mean() >= 0.999


def test_frontend_with_depth_calibration_matches_jax(unaligned):
    ds = unaligned
    fr = ds.frame(1)
    kw = dict(height=120, width=160, num_levels=2, max_keypoints=128,
              depth_intrinsics=ds.depth_intrinsics,
              T_color_depth=ds.T_color_depth)
    ref = jax_features_to_numpy(j_frontend(
        jnp.asarray(fr.gray), jnp.asarray(fr.depth), jnp.asarray(ds.intrinsics),
        JFrontendConfig(**kw)))
    got = features_to_numpy(frontend_gray_depth(
        fr.gray, fr.depth, ds.intrinsics, FrontendConfig(**kw), device="cpu"))
    for name in ("xy", "level", "score", "valid", "has_point"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    np.testing.assert_allclose(got["points"], ref["points"], rtol=0, atol=1e-5)
    assert ref["has_point"].sum() > 50
    # the aligned depth differs from the raw map: the calibration was used
    raw = features_to_numpy(frontend_gray_depth(
        fr.gray, fr.depth, ds.intrinsics,
        FrontendConfig(height=120, width=160, num_levels=2, max_keypoints=128),
        device="cpu"))
    assert not np.array_equal(raw["points"], got["points"])


def test_distort_pixels_matches_and_round_trips():
    intr = np.float32([300.0, 310.0, 160.0, 120.0])
    xy = np.random.RandomState(0).uniform([20, 20], [300, 220],
                                          (64, 2)).astype(np.float32)
    rect = np.asarray(jgeo.so3_exp(jnp.asarray([0.01, -0.02, 0.005])))
    for model, dist in (("brown_conrady", (-0.25, 0.06, 5e-4, 5e-4, 0.0)),
                        ("ftheta", (0.9,))):
        for R in (None, rect):
            ref = np.asarray(jgeo.distort_pixels(
                jnp.asarray(xy), jnp.asarray(intr), jnp.asarray(dist), model,
                None if R is None else jnp.asarray(R)))
            got = n(tgeo.distort_pixels(t(xy), t(intr), t(np.float32(dist)),
                                        model, None if R is None else t(R)))
            close(got, ref, rtol=0, atol=1e-4)
            back = n(tgeo.distort_pixels(
                tgeo.undistort_pixels(t(xy), t(intr), t(np.float32(dist)),
                                      model, None if R is None else t(R)),
                t(intr), t(np.float32(dist)), model,
                None if R is None else t(R)))
            close(back, xy, rtol=0, atol=2e-3)
