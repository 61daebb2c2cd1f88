"""The port's CLI over the committed dataset fixtures (CPU, in-process):
`python -m jetracer_orbslam2_torch.run --dataset DIR ... --device cpu` with
the JAX package's CLI tests' arguments and bars (`tests/test_dataset_e2e.py`,
`test_depth_align_ingest.py`, `test_cli_stereo_fixtures.py`,
`test_distortion.py`)."""

import json
import os

import pytest
import torch

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.io import datasets as tds

# small tensors only: see tests/_torch_port_util.py
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TUM = os.path.join(FIX, "tum_tiny")
TUM_UNALIGNED = os.path.join(FIX, "tum_tiny_unaligned")
EUROC = os.path.join(FIX, "euroc_tiny", "mav0")
EUROC_DIST = os.path.join(FIX, "euroc_tiny_dist", "mav0")
KITTI = os.path.join(FIX, "kitti_tiny")
NARROW = ["--levels", "3", "--max-keypoints", "256"]


def _run(argv, capsys):
    assert trun.main(argv + ["--json", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("native", [True, False])
def test_cli_tum_fixture(native, capsys, monkeypatch):
    """Both PNG decoders: the same tracking outcome."""
    if not native:
        monkeypatch.setenv("JETRACER_DISABLE_NATIVE", "1")
    before = dict(tds.DECODED)
    report = _run(["--dataset", TUM] + NARROW, capsys)
    served = {k: tds.DECODED[k] - before[k] for k in before}
    assert served["native" if native else "pil"] >= 48
    assert served["pil" if native else "native"] == 0
    assert report["frames"] == 24 and report["stereo"] is False
    assert report["keyframes"] >= 2
    assert report["tracked_frac"] > 0.9
    assert report["ate_rmse_m"] < 0.05, report


def test_cli_tum_unaligned_fixture(capsys):
    report = _run(["--dataset", TUM_UNALIGNED, "--levels", "2",
                   "--max-keypoints", "128"], capsys)
    assert report["frames"] == 24
    assert report["tracked_frac"] > 0.9
    assert report["ate_rmse_m"] < 0.05, report


def test_cli_euroc_fixture(capsys):
    report = _run(["--dataset", EUROC] + NARROW, capsys)
    assert report["frames"] == 16 and report["stereo"] is True
    assert report["tracked_frac"] > 0.9
    assert report["ate_rmse_m"] < 0.2, report
    # the IMU csv was consumed: gravity shows as a roll of about pi/2
    assert abs(report["attitude_rad"][0]) > 1.0, report


def test_cli_euroc_fixture_chunked(capsys):
    report = _run(["--dataset", EUROC] + NARROW
                  + ["--chunked", "4", "--fast-min-threshold", "7"], capsys)
    assert report["mode"] == "slam-chunked4"
    assert report["stereo"] is True
    assert report["frames"] == 16
    assert report["ate_rmse_m"] < 0.2, report


def test_cli_euroc_dist_fixture(capsys):
    """Not pre-rectified: keypoint-level rectification from sensor.yaml."""
    report = _run(["--dataset", EUROC_DIST] + NARROW, capsys)
    assert report["frames"] == 16
    assert report["ate_rmse_m"] < 0.2, report


@pytest.mark.parametrize("extra", [[], ["--chunked", "4"]])
def test_cli_kitti_fixture(extra, capsys):
    report = _run(["--dataset", KITTI] + NARROW + extra, capsys)
    assert report["stereo"] is True
    assert report["frames"] == 16
    assert report["tracked_frac"] > 0.9
    assert report["ate_rmse_m"] < 0.06, report


def test_cli_odometry_mode_on_datasets(capsys):
    """--mode odometry runs on an RGB-D dataset (here cut by --max-frames)
    and refuses a stereo one with exit 2, as the JAX CLI does."""
    report = _run(["--dataset", TUM, "--mode", "odometry", "--levels", "2",
                   "--max-keypoints", "128", "--max-frames", "12"], capsys)
    assert report["mode"] == "odometry" and report["frames"] == 12
    assert report["tracked_frac"] == 1.0
    assert report["ate_rmse_m"] < 0.05, report
    assert trun.main(["--dataset", KITTI, "--mode", "odometry",
                      "--device", "cpu"]) == 2
    assert capsys.readouterr().out == ""
