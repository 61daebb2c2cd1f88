"""Telemetry of the PyTorch port vs the JAX package (CPU): the BSON codec,
the keypoint overlay, the publisher's bytes, the WebSocket server, and the
CLI's `--telemetry` stream read by a client as `viewer/index.html` reads it.

The WebSocket client below is a copy of the one in `tests/test_telemetry.py`
(the port's tests do not lean on a JAX test module's helpers), with one
change: a closed connection raises instead of reading empty chunks forever.
"""

import io
import json
import os
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jetracer_orbslam2_tpu.ops.overlay import overlay_keypoints as j_overlay
from jetracer_orbslam2_tpu.runtime import bson as jbson
from jetracer_orbslam2_tpu.runtime.telemetry import (
    TelemetryPublisher as JPublisher)

from jetracer_orbslam2_torch import run as trun
from jetracer_orbslam2_torch.ops.overlay import overlay_keypoints
from jetracer_orbslam2_torch.runtime import bson
from jetracer_orbslam2_torch.runtime.telemetry import (
    TelemetryPublisher, WebSocketServer, _accept_key)

from _torch_port_util import n, t

TUM = os.path.join(os.path.dirname(__file__), "fixtures", "tum_tiny")
# the fields tests/test_viewer_e2e.py requires of every telemetry document
VIEWER_FIELDS = ("ax", "ay", "az", "width", "height", "channels",
                 "keypoints_x", "keypoints_y", "image", "pose")


def _recv_exact(s, k: int) -> bytes:
    out = b""
    while len(out) < k:
        chunk = s.recv(k - len(out))
        if not chunk:
            raise ConnectionError("server closed the connection")
        out += chunk
    return out


def _ws_client_connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=3)
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    s.sendall(
        (f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
         "Upgrade: websocket\r\nConnection: Upgrade\r\n"
         f"Sec-WebSocket-Key: {key}\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = s.recv(4096)
        if not chunk:
            raise ConnectionError("no handshake")
        resp += chunk
    assert b"101" in resp.split(b"\r\n", 1)[0]
    assert _accept_key(key).encode() in resp
    return s


def _ws_read_binary(s):
    hdr = _recv_exact(s, 2)
    k = hdr[1] & 0x7F
    if k == 126:
        (k,) = struct.unpack(">H", _recv_exact(s, 2))
    elif k == 127:
        (k,) = struct.unpack(">Q", _recv_exact(s, 8))
    return _recv_exact(s, k)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _every_type_doc():
    rng = np.random.default_rng(5)
    return {
        "ax": 12, "ay": -3, "az": np.int32(178),
        "big": 2 ** 40, "neg_big": -(2 ** 33), "edge": 2 ** 31 - 1,
        "score": 0.5, "f32": np.float32(1.25), "name": "frame", "empty": "",
        "flag": True, "off": False,
        "blob": np.arange(16, dtype=np.int16),
        "pose": rng.normal(size=(4, 4)).astype(np.float32),
        "raw": b"\x00\xff\x10", "buf": bytearray(b"abc"),
    }


def test_bson_encode_is_byte_equal_to_jax_and_round_trips():
    doc = _every_type_doc()
    data = bson.encode(doc)
    assert data == jbson.encode(doc)
    out = bson.decode(data)
    assert out == jbson.decode(data)
    assert out["ax"] == 12 and out["az"] == 178 and out["big"] == 2 ** 40
    assert out["neg_big"] == -(2 ** 33) and out["edge"] == 2 ** 31 - 1
    assert out["score"] == 0.5 and out["f32"] == 1.25
    assert out["name"] == "frame" and out["empty"] == ""
    assert out["flag"] is True and out["off"] is False
    np.testing.assert_array_equal(np.frombuffer(out["blob"], np.int16),
                                  np.arange(16, dtype=np.int16))
    np.testing.assert_array_equal(
        np.frombuffer(out["pose"], np.float32).reshape(4, 4), doc["pose"])
    assert out["raw"] == b"\x00\xff\x10" and out["buf"] == b"abc"
    with pytest.raises(TypeError):
        bson.encode({"bad": [1, 2]})


def _overlay_case(seed, h=64, w=80):
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (h, w)).astype(np.float32)
    inside = rng.uniform([0, 0], [w, h], (40, 2))
    special = np.asarray([
        [0.0, 0.0], [w - 1, 0.0], [0.0, h - 1], [w - 1, h - 1],   # corners
        [w - 0.5, h - 0.5], [w - 1.2, 10.0], [20.0, h - 1.7],    # border
        [-0.5, 5.0], [5.0, -0.5], [-1.0, -1.0],                   # partly out
        [w, 10.0], [10.0, h], [-3.0, 20.0], [200.0, 300.0],       # outside
    ])
    xy = np.concatenate([inside, special]).astype(np.float32)
    valid = rng.random(len(xy)) > 0.2
    valid[:4] = True
    valid[-1] = False                                             # invalid
    return gray, xy, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_overlay_keypoints_equals_jax(seed):
    gray, xy, valid = _overlay_case(seed)
    want = np.asarray(j_overlay(jnp.asarray(gray), jnp.asarray(xy),
                                jnp.asarray(valid)))
    got = overlay_keypoints(t(gray), t(xy), t(valid))
    assert torch.equal(got, t(want))
    assert got.dtype == torch.float32 and got.shape == gray.shape
    # the input is untouched and some dots were burnt in
    assert (n(got) != gray).any() and not torch.equal(t(gray), got)
    # value= is honoured (an integer image too)
    got0 = overlay_keypoints(t(gray).to(torch.int32), t(xy), t(valid), value=7)
    want0 = np.asarray(j_overlay(jnp.asarray(gray, jnp.int32), jnp.asarray(xy),
                                 jnp.asarray(valid), 7))
    np.testing.assert_array_equal(n(got0), want0)


class _Capture:
    """Stands in for the server: keeps each payload the publisher sends."""

    def __init__(self):
        self.payloads = []

    def broadcast(self, payload: bytes) -> bool:
        self.payloads.append(payload)
        return True


@pytest.mark.parametrize("burn", [False, True])
@pytest.mark.parametrize("image", [True, False])
@pytest.mark.parametrize("with_pose", [True, False])
def test_publisher_bytes_equal_jax(burn, image, with_pose):
    """The same frame gives the JAX publisher's bytes: numpy in on the JAX
    side, CPU tensors (and numpy) on the port's; PIL's JPEG on both."""
    gray, xy, valid = _overlay_case(3)
    pose = np.random.default_rng(2).normal(size=(4, 4))
    pose[3] = [0, 0, 0, 1]
    euler = np.degrees([0.03, -1.2, 3.1])
    jcap, tcap, ncap = _Capture(), _Capture(), _Capture()
    JPublisher(jcap, send_image=image, burn_overlay=burn).publish(
        gray, xy, valid, euler_deg=euler, pose=pose if with_pose else None)
    TelemetryPublisher(tcap, send_image=image, burn_overlay=burn).publish(
        t(gray), t(xy), t(valid), euler_deg=euler,
        pose=t(pose) if with_pose else None)
    TelemetryPublisher(ncap, send_image=image, burn_overlay=burn).publish(
        gray, xy, valid, euler_deg=euler, pose=pose if with_pose else None)
    assert tcap.payloads == jcap.payloads == ncap.payloads
    doc = bson.decode(tcap.payloads[0])
    assert ("image" in doc) is image and ("pose" in doc) is with_pose
    kx = np.frombuffer(doc["keypoints_x"], np.int16)
    np.testing.assert_array_equal(kx, xy[valid, 0].astype(np.int16))
    assert (doc["ax"], doc["ay"], doc["az"]) == (1, -68, 177)


def test_publisher_burns_in_on_the_image_device():
    """With burn_overlay the published image is the overlay's, wherever the
    frame lies (the JPEG differs from the plain frame's)."""
    gray, xy, valid = _overlay_case(4)
    plain, burnt = _Capture(), _Capture()
    TelemetryPublisher(plain).publish(t(gray), t(xy), t(valid))
    TelemetryPublisher(burnt, burn_overlay=True).publish(t(gray), t(xy), t(valid))
    a = bson.decode(plain.payloads[0])["image"]
    b = bson.decode(burnt.payloads[0])["image"]
    assert a[:2] == b[:2] == b"\xff\xd8" and a != b
    img = np.asarray(Image.open(io.BytesIO(b)))
    assert img.shape == gray.shape


def test_websocket_broadcast_and_receive():
    got = []
    srv = WebSocketServer(port=0, on_message=got.append).start()
    try:
        c = _ws_client_connect(srv.port)
        deadline = time.time() + 3
        while srv.num_clients == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.num_clients == 1

        pub = TelemetryPublisher(srv, send_image=True)
        gray = (np.random.default_rng(0).uniform(0, 255, (48, 64))
                .astype(np.float32))
        xy = torch.tensor([[5.0, 6.0], [10.0, 12.0], [1.0, 1.0]])
        valid = torch.tensor([True, True, False])
        assert pub.publish(torch.from_numpy(gray), xy, valid,
                           euler_deg=(1, 2, 3), pose=torch.eye(4))
        doc = bson.decode(_ws_read_binary(c))
        assert doc["width"] == 64 and doc["height"] == 48
        assert doc["ax"] == 1 and doc["az"] == 3
        np.testing.assert_array_equal(
            np.frombuffer(doc["keypoints_x"], np.int16), [5, 10])
        assert doc["image"][:2] == b"\xff\xd8"
        np.testing.assert_allclose(
            np.frombuffer(doc["pose"], np.float32).reshape(4, 4), np.eye(4))

        # client -> server command path (masked frame)
        msg = b'{"message":"test"}'
        mask = b"\x01\x02\x03\x04"
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(msg))
        c.sendall(bytes([0x81, 0x80 | len(msg)]) + mask + masked)
        deadline = time.time() + 3
        while not got and time.time() < deadline:
            time.sleep(0.01)
        assert got and got[0] == msg
        c.close()
    finally:
        srv.close()
    assert srv.sent_frames == 1 and srv.dropped_frames == 0


def test_websocket_rate_limit_drops():
    srv = WebSocketServer(port=0, rate_bytes_per_s=10_000).start()
    try:
        big = b"x" * 6000
        assert srv.broadcast(big) is True
        assert srv.broadcast(big) is False     # budget exhausted -> drop
        assert srv.dropped_frames == 1
        time.sleep(0.7)                         # refill
        assert srv.broadcast(big) is True
        assert srv.sent_frames == 2
    finally:
        srv.close()


class _Client(threading.Thread):
    """Connects as soon as the server listens, then decodes every document
    until the server closes the connection."""

    def __init__(self, port):
        super().__init__(daemon=True)
        self.port = port
        self.docs = []
        self.error = None

    def run(self):
        deadline = time.time() + 120
        sock = None
        while sock is None:
            try:
                sock = _ws_client_connect(self.port)
            except OSError:
                if time.time() > deadline:
                    self.error = "no server"
                    return
                time.sleep(0.02)
        sock.settimeout(120)
        try:
            while True:
                self.docs.append(bson.decode(_ws_read_binary(sock)))
        except (ConnectionError, OSError):
            pass
        finally:
            sock.close()


def test_cli_telemetry_stream(capsys, monkeypatch, tmp_path):
    """`--telemetry PORT` on the TUM fixture (in-process, on the CPU): a
    client that connected before the first frame receives every frame's
    document, each with the fields the viewer renders."""
    start = WebSocketServer.start

    def start_then_wait_for_client(self):
        out = start(self)
        deadline = time.time() + 60
        while self.num_clients == 0 and time.time() < deadline:
            time.sleep(0.01)
        return out

    monkeypatch.setattr(WebSocketServer, "start", start_then_wait_for_client)
    port = _free_port()
    client = _Client(port)
    client.start()
    assert trun.main(["--dataset", TUM, "--levels", "2", "--max-keypoints",
                      "128", "--telemetry", str(port), "--json",
                      "--device", "cpu"]) == 0
    client.join(timeout=30)
    assert not client.is_alive() and client.error is None
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 24
    assert report["telemetry_sent"] + report["telemetry_dropped"] == 24
    assert len(client.docs) == report["telemetry_sent"] >= 2
    for doc in client.docs:
        for field in VIEWER_FIELDS:
            assert field in doc, f"missing {field}"
        assert doc["width"] == 160 and doc["height"] == 120
        assert doc["channels"] == 1
        kx = np.frombuffer(doc["keypoints_x"], np.int16)
        ky = np.frombuffer(doc["keypoints_y"], np.int16)
        assert 0 < len(kx) == len(ky) <= 128
        assert (kx >= 0).all() and (kx < 160).all()
        assert (ky >= 0).all() and (ky < 120).all()
        assert doc["image"][:2] == b"\xff\xd8"
        pose = np.frombuffer(doc["pose"], np.float32).reshape(4, 4)
        np.testing.assert_allclose(pose[3], [0, 0, 0, 1], atol=1e-6)
        assert Image.open(io.BytesIO(doc["image"])).size == (160, 120)
