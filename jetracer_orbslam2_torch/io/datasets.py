"""Dataset loaders: TUM RGB-D, EuRoC MAV stereo, KITTI odometry.

Counterpart of `jetracer_orbslam2_tpu/io/datasets.py`: host numpy, a copy of
it, with PNG decoding through the port's own native decoder
(`io/native_loader.py`) and PIL behind it.  All loaders present one
interface: an object with

    __len__
    frame(i)     -> Frame (numpy arrays, HxW float32 gray in [0,255],
                    HxW float32 depth in meters or None, optional right img)
    groundtruth  -> (N, 4, 4) float32 T_wc or None
    intrinsics   -> (4,) fx fy cx cy
    baseline     -> float (stereo) or 0.0

plus the calibration fields a camera needs (`dist`, `dist_r`, `rect_l`,
`rect_r`, `intrinsics_r`, `depth_intrinsics`, `depth_dist`,
`T_color_depth`).  Frames stay numpy; the caller moves them to its device.
`DECODED` counts the PNG files each decoder served in this process.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Frame:
    gray: np.ndarray                  # (H, W) float32 [0, 255]
    depth: Optional[np.ndarray]       # (H, W) float32 meters, or None
    right: Optional[np.ndarray]       # (H, W) float32 right image (stereo)
    timestamp: float
    index: int


DECODED = {"native": 0, "pil": 0}
_decoded_lock = threading.Lock()     # decode threads count concurrently


def _count_decode(which: str) -> None:
    with _decoded_lock:
        DECODED[which] += 1


def _read_png(path: str) -> Optional[np.ndarray]:
    """Native C++ decode when the library builds (io/native_loader.py);
    None -> caller falls back to PIL."""
    from jetracer_orbslam2_torch.io import native_loader

    if not native_loader.available():
        return None
    try:
        out = native_loader.decode_png_file(path)
    except ValueError:
        return None          # unsupported PNG variant -> PIL fallback
    _count_decode("native")
    return out


def _pil_open(path: str):
    from PIL import Image

    _count_decode("pil")
    return Image.open(path)


def _to_gray(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.astype(np.float32)
    # reference weights: B*0.07 + G*0.72 + R*0.21
    # (src/cuda/cuda_RGB_to_Grayscale.cu:10-33), as ops/preprocess
    a = arr.astype(np.float32)
    return a[..., 0] * 0.21 + a[..., 1] * 0.72 + a[..., 2] * 0.07


def _imread_gray(path: str) -> np.ndarray:
    arr = _read_png(path)
    if arr is not None:
        return _to_gray(arr)
    img = _pil_open(path)
    if img.mode not in ("L", "I;16", "I"):
        img = img.convert("L")
    out = np.asarray(img)
    if out.dtype == np.uint16:
        raise ValueError(f"{path}: 16-bit image where 8-bit expected")
    return out.astype(np.float32)


def _imread_rgb_as_gray(path: str) -> np.ndarray:
    arr = _read_png(path)
    if arr is not None:
        return _to_gray(arr)
    img = _pil_open(path)
    if img.mode == "L":
        return np.asarray(img).astype(np.float32)
    return _to_gray(np.asarray(img.convert("RGB")))


def _imread_depth16(path: str, scale: float) -> np.ndarray:
    arr = _read_png(path)
    if arr is None:
        arr = np.asarray(_pil_open(path))
    return arr.astype(np.float32) * scale


def _rodrigues_log(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (3,) axis-angle (host-side, numpy)."""
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-9:
        return np.zeros(3)
    v = np.asarray([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (theta / (2.0 * np.sin(theta)))


def _rodrigues_exp(w: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def stereo_rectify_rotations(R: np.ndarray, t: np.ndarray):
    """Bouguet stereo rectification, keypoint-level form.

    R, t: cam1 <- cam0 rigid transform (p_c1 = R @ p_c0 + t), from the
    cameras' extrinsics (EuRoC: inv(T_BS_cam1) @ T_BS_cam0).  Returns
    (R_l, R_r, baseline): rotations such that applying R_l / R_r to the
    two cameras' (undistorted) viewing rays puts both in a common frame
    whose x-axis is the baseline — after which rows align and disparity
    is valid.  Split-the-difference construction (each camera rotates by
    half the relative rotation, then both rotate so the baseline lands on
    -x for cam1), the same construction OpenCV's stereoRectify uses.
    Consumed by models/stereo.frontend_stereo(rect_l=..., rect_r=...).
    """
    w = _rodrigues_log(R)
    half_back = _rodrigues_exp(-0.5 * w)       # undoes half of R
    t_mid = half_back @ t
    b = float(np.linalg.norm(t))
    e1 = -t_mid / max(np.linalg.norm(t_mid), 1e-12)
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-6:                              # baseline ~ optical axis
        e2 = np.cross([0.0, 1.0, 0.0], e1)
        n2 = np.linalg.norm(e2)
    e2 = e2 / n2
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3])
    R_r = Rw @ half_back
    R_l = Rw @ _rodrigues_exp(0.5 * w)
    return (R_l.astype(np.float32), R_r.astype(np.float32), b)


def _associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float):
    """Nearest-timestamp association a->b (TUM tooling convention)."""
    out = []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            out.append((i, j))
    return out


class TumRGBD:
    """TUM RGB-D directory: rgb.txt / depth.txt / groundtruth.txt +
    rgb/*.png (8-bit) + depth/*.png (16-bit, 1/5000 m)."""

    def __init__(self, root: str, max_dt: float = 0.02,
                 depth_scale: float = 1.0 / 5000.0):
        self.root = root
        self.depth_scale = depth_scale
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        dep = self._read_list(os.path.join(root, "depth.txt"))
        pairs = _associate(
            np.asarray([t for t, _ in rgb]),
            np.asarray([t for t, _ in dep]), max_dt)
        self.items = [
            (rgb[i][0], rgb[i][1], dep[j][1]) for i, j in pairs]
        self.gt = self._read_groundtruth(
            os.path.join(root, "groundtruth.txt"),
            np.asarray([t for t, _, _ in self.items]))
        # freiburg-1 defaults; an optional intrinsics.txt ("fx fy cx cy"
        # optionally followed by "k1 k2 p1 p2 k3" Brown-Conrady coeffs —
        # the real freiburg cameras ARE distorted; TUM's published
        # ROS-default intrinsics assume pre-rectified tooling) beside
        # rgb.txt overrides them
        self.intrinsics = np.asarray(
            [525.0, 525.0, 319.5, 239.5], np.float32)
        self.dist = None
        self.dist_model = "brown_conrady"
        intr_path = os.path.join(root, "intrinsics.txt")
        if os.path.exists(intr_path):
            with open(intr_path) as f:
                vals = [float(x) for x in f.read().split()]
            self.intrinsics = np.asarray(vals[:4], np.float32)
            if len(vals) >= 9 and any(v != 0.0 for v in vals[4:9]):
                self.dist = tuple(vals[4:9])
        self.baseline = 0.0
        # optional depth_calib.txt marks UNREGISTERED depth (the raw
        # RealSense situation the reference aligns on every frame,
        # src/cuda/cuda-align.cu:366-399): line 1 = depth camera
        # "fx fy cx cy" (+ optional "k1 k2 p1 p2 k3"), then 16 numbers of
        # the row-major color<-depth extrinsic T_color_depth
        self.depth_intrinsics = None
        self.depth_dist = None
        self.T_color_depth = None
        dc_path = os.path.join(root, "depth_calib.txt")
        if os.path.exists(dc_path):
            with open(dc_path) as f:
                lines = [ln for ln in f.read().splitlines()
                         if ln.strip() and not ln.startswith("#")]
            head = [float(x) for x in lines[0].split()]
            self.depth_intrinsics = tuple(head[:4])
            if len(head) >= 9 and any(v != 0.0 for v in head[4:9]):
                self.depth_dist = tuple(head[4:9])
            T = [float(x) for ln in lines[1:] for x in ln.split()]
            assert len(T) == 16, f"{dc_path}: expected 16 extrinsic values"
            self.T_color_depth = tuple(T)

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out

    def _read_groundtruth(self, path, ts):
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        rows = np.asarray(rows)
        poses = []
        for t in ts:
            r = rows[np.argmin(np.abs(rows[:, 0] - t))]
            tx, ty, tz, qx, qy, qz, qw = r[1:8]
            poses.append(_pose_from_quat(tx, ty, tz, qx, qy, qz, qw))
        return np.stack(poses).astype(np.float32)

    def __len__(self):
        return len(self.items)

    def frame(self, i: int) -> Frame:
        ts, rgb_rel, dep_rel = self.items[i]
        return Frame(
            gray=_imread_rgb_as_gray(os.path.join(self.root, rgb_rel)),
            depth=_imread_depth16(
                os.path.join(self.root, dep_rel), self.depth_scale),
            right=None, timestamp=ts, index=i)

    @property
    def groundtruth(self):
        return self.gt


class EurocStereo:
    """EuRoC MAV mav0/ layout: cam0/data.csv + cam0/data/*.png (+cam1).

    Handles REAL (non-pre-rectified) distributions: when the sensor.yaml
    files carry `distortion_coefficients` / `distortion_model` and per-
    camera `T_BS` extrinsics, the loader computes the Bouguet rectifying
    rotations (stereo_rectify_rotations) and the baseline from the
    extrinsics, and exposes them as `dist` / `dist_r` / `rect_l` /
    `rect_r` / `intrinsics_r` for the keypoint-level rectification in
    models/stereo.frontend_stereo.  Pre-rectified sets (no distortion, no
    T_BS) keep the fast path with all of those None.
    """

    def __init__(self, root: str,
                 intrinsics=(435.2046, 435.2046, 367.4517, 252.2008),
                 baseline: float = 0.110074):
        self.root = root
        self.left = self._read_csv(os.path.join(root, "cam0", "data.csv"))
        self.right = self._read_csv(os.path.join(root, "cam1", "data.csv"))
        rts = np.asarray([t for t, _ in self.right])
        self.pairs = []
        for t, name in self.left:
            j = int(np.argmin(np.abs(rts - t)))
            if abs(rts[j] - t) < 0.005:
                self.pairs.append((t, name, self.right[j][1]))
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.baseline = baseline
        self.dist = None
        self.dist_model = "brown_conrady"
        self.dist_r = None
        self.rect_l = None
        self.rect_r = None
        self.intrinsics_r = None
        cal0 = self._parse_sensor_yaml(
            os.path.join(root, "cam0", "sensor.yaml"))
        cal1 = self._parse_sensor_yaml(
            os.path.join(root, "cam1", "sensor.yaml"))
        if cal0.get("intrinsics") is not None:
            self.intrinsics = cal0["intrinsics"]
        if cal0.get("baseline") is not None:       # fixture shorthand
            self.baseline = cal0["baseline"]
        d0, d1 = cal0.get("dist"), cal1.get("dist")
        T0, T1 = cal0.get("T_BS"), cal1.get("T_BS")
        distorted = ((d0 is not None and np.any(d0 != 0.0))
                     or (d1 is not None and np.any(d1 != 0.0)))
        if T0 is not None and T1 is not None:
            T_c1_c0 = np.linalg.inv(T1) @ T0
            rotated = not np.allclose(T_c1_c0[:3, :3], np.eye(3), atol=1e-6)
            if distorted or rotated:
                R_l, R_r, b = stereo_rectify_rotations(
                    T_c1_c0[:3, :3], T_c1_c0[:3, 3])
                self.rect_l = tuple(float(x) for x in R_l.ravel())
                self.rect_r = tuple(float(x) for x in R_r.ravel())
                self.baseline = b
                self.dist = (None if d0 is None or not np.any(d0 != 0.0)
                             else tuple(float(x) for x in d0))
                self.dist_r = (None if d1 is None or not np.any(d1 != 0.0)
                               else tuple(float(x) for x in d1))
                self.dist_model = cal0.get("model", "brown_conrady")
                if cal1.get("intrinsics") is not None:
                    self.intrinsics_r = cal1["intrinsics"]
        elif distorted:
            # distortion without extrinsics: undistort-only (parallel rig)
            self.dist = (None if d0 is None or not np.any(d0 != 0.0)
                         else tuple(float(x) for x in d0))
            self.dist_r = (None if d1 is None or not np.any(d1 != 0.0)
                           else tuple(float(x) for x in d1))
            self.dist_model = cal0.get("model", "brown_conrady")
            if cal1.get("intrinsics") is not None:
                self.intrinsics_r = cal1["intrinsics"]
        self.gt = self._read_groundtruth(
            os.path.join(root, "state_groundtruth_estimate0", "data.csv"),
            np.asarray([t for t, _, _ in self.pairs]))

    @staticmethod
    def _parse_sensor_yaml(path):
        """Minimal parser for the EuRoC sensor.yaml fields we consume (no
        YAML dep): intrinsics, distortion_coefficients, distortion_model,
        T_BS (whose `data:` list may span lines), plus the non-standard
        `baseline:` shorthand our fixtures use."""
        out = {}
        if not os.path.exists(path):
            return out
        with open(path) as f:
            text = f.read()

        def bracket_list(key):
            i = text.find(key)
            if i < 0:
                return None
            j = text.index("[", i)
            k = text.index("]", j)
            return np.asarray(
                [float(x) for x in text[j + 1:k].replace("\n", " ").split(",")
                 if x.strip()], np.float32)

        intr = bracket_list("intrinsics:")
        if intr is not None:
            out["intrinsics"] = intr[:4]
        dist = bracket_list("distortion_coefficients:")
        if dist is not None:
            # radial-tangential ships k1 k2 p1 p2 (k3 implied 0); ftheta w
            d5 = np.zeros(5, np.float32)
            d5[:min(5, dist.size)] = dist[:5]
            out["dist"] = d5
        tbs_i = text.find("T_BS")
        if tbs_i >= 0:
            data = bracket_list("data:")
            if data is not None and data.size == 16:
                out["T_BS"] = data.reshape(4, 4).astype(np.float64)
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("baseline:"):
                out["baseline"] = float(s.split(":", 1)[1])
            elif s.startswith("distortion_model:"):
                name = s.split(":", 1)[1].strip()
                out["model"] = {
                    "radial-tangential": "brown_conrady",
                    "radtan": "brown_conrady",
                    "brown_conrady": "brown_conrady",
                    "ftheta": "ftheta",
                }.get(name, "brown_conrady")
        return out

    @staticmethod
    def _read_csv(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_ns, name = line.split(",")[:2]
                out.append((int(ts_ns) * 1e-9, name.strip()))
        return out

    def _read_groundtruth(self, path, ts):
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.split(",")[:8]]
                rows.append(v)
        rows = np.asarray(rows)
        rows[:, 0] *= 1e-9
        poses = []
        for t in ts:
            r = rows[np.argmin(np.abs(rows[:, 0] - t))]
            tx, ty, tz, qw, qx, qy, qz = r[1:8]   # EuRoC: w first
            poses.append(_pose_from_quat(tx, ty, tz, qx, qy, qz, qw))
        return np.stack(poses).astype(np.float32)

    def __len__(self):
        return len(self.pairs)

    def frame(self, i: int) -> Frame:
        ts, lname, rname = self.pairs[i]
        return Frame(
            gray=_imread_gray(
                os.path.join(self.root, "cam0", "data", lname)),
            depth=None,
            right=_imread_gray(
                os.path.join(self.root, "cam1", "data", rname)),
            timestamp=ts, index=i)

    @property
    def groundtruth(self):
        return self.gt

    def imu_packets(self, max_samples: int = 16):
        """Per-frame IMU packets from imu0/data.csv
        (ts[ns], wx, wy, wz [rad/s], ax, ay, az [m/s^2]); None if the
        sequence ships no IMU.  Reference streams the equivalent live data
        (src/RealSense/RealSenseD400.cpp:114-150)."""
        path = os.path.join(self.root, "imu0", "data.csv")
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = line.split(",")[:7]
                rows.append([float(x) for x in v])
        rows = np.asarray(rows, np.float64)
        imu_ts = rows[:, 0] * 1e-9
        gyro = rows[:, 1:4].astype(np.float32)
        accel = rows[:, 4:7].astype(np.float32)
        frame_ts = np.asarray([t for t, _, _ in self.pairs], np.float64)
        return build_imu_packets(imu_ts, gyro, accel, frame_ts, max_samples)


class KittiOdometry:
    """KITTI odometry sequence dir: image_0/, image_1/, times.txt,
    calib.txt (P0/P1 projection rows); poses optionally at poses.txt."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.intrinsics, self.baseline = self._read_calib(
            os.path.join(root, "calib.txt"))
        self.dist = None                 # KITTI ships rectified images
        self.dist_model = "brown_conrady"
        self.gt = self._read_poses(os.path.join(root, "poses.txt"))

    @staticmethod
    def _read_calib(path):
        p = {}
        with open(path) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    p[k.strip()] = np.asarray(
                        [float(x) for x in v.split()]).reshape(3, 4)
        P0, P1 = p["P0"], p["P1"]
        fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
        baseline = -(P1[0, 3] - P0[0, 3]) / fx
        return np.asarray([fx, fy, cx, cy], np.float32), float(baseline)

    @staticmethod
    def _read_poses(path):
        if not os.path.exists(path):
            return None
        rows = np.loadtxt(path).reshape(-1, 3, 4)
        n = rows.shape[0]
        out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        out[:, :3, :] = rows
        return out

    def __len__(self):
        return len(self.times)

    def frame(self, i: int) -> Frame:
        name = f"{i:06d}.png"
        return Frame(
            gray=_imread_gray(os.path.join(self.root, "image_0", name)),
            depth=None,
            right=_imread_gray(os.path.join(self.root, "image_1", name)),
            timestamp=self.times[i], index=i)

    @property
    def groundtruth(self):
        return self.gt


def build_imu_packets(
    imu_ts: np.ndarray,     # (M,) float64 ABSOLUTE seconds
    gyro: np.ndarray,       # (M, 3)
    accel: np.ndarray,      # (M, 3)
    frame_ts: np.ndarray,   # (N,) float64 ABSOLUTE seconds
    max_samples: int = 16,
):
    """Bucket raw IMU samples into fixed-size per-frame packets.

    Packet i holds the samples with frame_ts[i-1] < t <= frame_ts[i]
    (packet 0: everything up to the first frame).  Timestamps are converted
    to float32 seconds RELATIVE to the first frame — float32 cannot
    represent epoch seconds (resolution ~128 s at 1.4e9), so the subtraction
    happens here in float64 (models/imu.py module docstring).

    Returns (gyro (N,S,3) f32, gyro_ts (N,S) f32, accel (N,S,3) f32,
    gyro_valid (N,S) bool, accel_valid (N,S) bool); overflow beyond
    max_samples keeps the NEWEST samples (attitude is an exponential
    filter — the stalest samples matter least).
    """
    n, S = len(frame_ts), max_samples
    t0 = np.float64(frame_ts[0])
    out_g = np.zeros((n, S, 3), np.float32)
    out_gt = np.zeros((n, S), np.float32)
    out_a = np.zeros((n, S, 3), np.float32)
    ok_g = np.zeros((n, S), bool)
    ok_a = np.zeros((n, S), bool)
    edges = np.concatenate([[-np.inf], np.asarray(frame_ts, np.float64)])
    which = np.searchsorted(edges, np.asarray(imu_ts, np.float64),
                            side="left") - 1
    rel = (np.asarray(imu_ts, np.float64) - t0).astype(np.float32)
    for i in range(n):
        idx = np.nonzero(which == i)[0][-S:]
        k = len(idx)
        out_g[i, :k] = gyro[idx]
        out_gt[i, :k] = rel[idx]
        out_a[i, :k] = accel[idx]
        ok_g[i, :k] = True
        ok_a[i, :k] = True
    return out_g, out_gt, out_a, ok_g, ok_a


def _pose_from_quat(tx, ty, tz, qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.asarray([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (tx, ty, tz)
    return T


def open_dataset(path: str):
    """Sniff the directory layout and return the right loader."""
    if os.path.exists(os.path.join(path, "rgb.txt")):
        return TumRGBD(path)
    if os.path.exists(os.path.join(path, "cam0", "data.csv")):
        return EurocStereo(path)
    if os.path.exists(os.path.join(path, "times.txt")):
        return KittiOdometry(path)
    raise ValueError(f"unrecognized dataset layout at {path}")
