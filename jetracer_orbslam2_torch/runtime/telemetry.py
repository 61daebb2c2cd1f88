"""Live telemetry: WebSocket broadcast server + SLAM frame publisher.

Counterpart of `jetracer_orbslam2_tpu/runtime/telemetry.py`.  The server is a
copy of it: the reference's ground-station link
(reference src/WebSocket/WebSocketCom.cpp:85-252 — websocketpp server on
port 9002, token-bucket rate limit ~5 MB/s, BSON frames of
{ax, ay, az, width, height, channels, keypoints_x, keypoints_y, image})
as a standard-library RFC 6455 server, broadcast-only (incoming messages are
parsed and surfaced to an optional callback, like the reference's vestigial
command path, WebSocketCom.cpp:36-60).  The publisher takes the port's
tensors, wherever they lie, and builds the JAX package's document byte for
byte from them with one device-to-host fetch a frame.
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from jetracer_orbslam2_torch.ops.overlay import overlay_keypoints
from jetracer_orbslam2_torch.runtime import bson

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def _encode_frame(payload: bytes, opcode: int = 0x2) -> bytes:
    """Server->client frame (no masking), binary by default."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([n])
    elif n < 2 ** 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class WebSocketServer:
    """Threaded broadcast server with the reference's drop-on-budget
    policy: when the rate budget is exhausted, frames are skipped, not
    queued (WebSocketCom.cpp:153-216)."""

    def __init__(self, port: int = 9002, host: str = "127.0.0.1",
                 rate_bytes_per_s: int = 5_000_000,
                 on_message: Optional[Callable[[bytes], None]] = None):
        self.host = host
        self.port = port
        self.rate = rate_bytes_per_s
        self.on_message = on_message
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._budget = float(rate_bytes_per_s)
        self._last_refill = time.monotonic()
        self.sent_frames = 0
        self.dropped_frames = 0
        self._srv: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WebSocketServer":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        self.port = srv.getsockname()[1]     # resolve port 0
        srv.listen(4)
        srv.settimeout(0.2)
        self._srv = srv
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket):
        try:
            conn.settimeout(2.0)
            req = b""
            while b"\r\n\r\n" not in req:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                req += chunk
            key = None
            for line in req.decode(errors="replace").split("\r\n"):
                if line.lower().startswith("sec-websocket-key:"):
                    key = line.split(":", 1)[1].strip()
            if key is None:
                conn.close()
                return
            resp = (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n")
            conn.sendall(resp.encode())
            conn.settimeout(0.1)
            with self._lock:
                self._clients.append(conn)
            self._read_loop(conn)
        except OSError:
            self._drop_client(conn)

    def _read_loop(self, conn: socket.socket):
        buf = b""
        while not self._stop.is_set():
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            buf = self._consume_frames(conn, buf)
        self._drop_client(conn)

    def _consume_frames(self, conn, buf: bytes) -> bytes:
        while len(buf) >= 2:
            opcode = buf[0] & 0x0F
            masked = buf[1] & 0x80
            n = buf[1] & 0x7F
            off = 2
            if n == 126:
                if len(buf) < 4:
                    return buf
                (n,) = struct.unpack_from(">H", buf, 2)
                off = 4
            elif n == 127:
                if len(buf) < 10:
                    return buf
                (n,) = struct.unpack_from(">Q", buf, 2)
                off = 10
            mask = b"\x00" * 4
            if masked:
                if len(buf) < off + 4:
                    return buf
                mask = buf[off:off + 4]
                off += 4
            if len(buf) < off + n:
                return buf
            payload = bytes(b ^ mask[i % 4]
                            for i, b in enumerate(buf[off:off + n]))
            buf = buf[off + n:]
            if opcode == 0x8:                      # close
                raise OSError("client closed")
            if opcode == 0x9:                      # ping -> pong
                conn.sendall(_encode_frame(payload, opcode=0xA))
            elif opcode in (0x1, 0x2) and self.on_message:
                self.on_message(payload)
        return buf

    def _drop_client(self, conn):
        with self._lock:
            if conn in self._clients:
                self._clients.remove(conn)
        try:
            conn.close()
        except OSError:
            pass

    @property
    def num_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def broadcast(self, payload: bytes) -> bool:
        """Send to all clients, subject to the rate budget.  Returns False
        when the frame was dropped for budget (reference behavior)."""
        now = time.monotonic()
        self._budget = min(
            self.rate, self._budget + (now - self._last_refill) * self.rate)
        self._last_refill = now
        if len(payload) > self._budget:
            self.dropped_frames += 1
            return False
        self._budget -= len(payload)
        frame = _encode_frame(payload)
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sendall(frame)
            except OSError:
                self._drop_client(c)
        self.sent_frames += 1
        return True

    def close(self):
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()


class TelemetryPublisher:
    """Builds the reference's per-frame BSON telemetry document
    (WebSocketCom.cpp:161-187) from SLAM outputs and broadcasts it."""

    def __init__(self, server: WebSocketServer, send_image: bool = True,
                 jpeg_quality: int = 90, burn_overlay: bool = False):
        """burn_overlay: raster the keypoint dots into the image, on the
        device that holds it, before JPEG (the reference's server-side
        overlay, post_processing.cu:45-70); off by default because the
        shipped viewer composites the overlay client-side from
        keypoints_x/y."""
        self.server = server
        self.send_image = send_image
        self.jpeg_quality = jpeg_quality
        self.burn_overlay = burn_overlay

    def publish(self, gray, keypoints_xy, valid, euler_deg=(0, 0, 0),
                pose=None) -> bool:
        """gray (H, W), keypoints_xy (K, 2), valid (K,) and pose (4, 4):
        numpy arrays or tensors on any device.  What lies on a CUDA device
        comes to the host in one fetch."""
        h, w = gray.shape
        burn = self.burn_overlay and self.send_image
        if burn and _on_card(gray):
            # burn in where the image lies, then fetch it with the rest
            g = gray.to(torch.float32)
            image = overlay_keypoints(
                g, torch.as_tensor(keypoints_xy).to(g.device, torch.float32),
                torch.as_tensor(valid).to(g.device))
            image, keypoints_xy, valid, pose = _to_host(
                image, keypoints_xy, valid, pose)
        else:
            image, keypoints_xy, valid, pose = _to_host(
                gray if self.send_image else None, keypoints_xy, valid, pose)
            if burn:
                image = overlay_keypoints(
                    torch.as_tensor(np.asarray(image, np.float32)),
                    torch.as_tensor(np.asarray(keypoints_xy, np.float32)),
                    torch.as_tensor(np.asarray(valid, bool))).numpy()
        valid = valid.astype(bool)
        kx = np.ascontiguousarray(
            keypoints_xy[valid, 0].astype(np.int16))
        ky = np.ascontiguousarray(
            keypoints_xy[valid, 1].astype(np.int16))
        doc = {
            "ax": int(euler_deg[0]), "ay": int(euler_deg[1]),
            "az": int(euler_deg[2]),
            "width": int(w), "height": int(h), "channels": 1,
            "keypoints_x": kx, "keypoints_y": ky,
        }
        if pose is not None:
            doc["pose"] = np.ascontiguousarray(pose.astype(np.float32))
        if self.send_image:
            doc["image"] = self._jpeg(image)
        return self.server.broadcast(bson.encode(doc))

    def _jpeg(self, gray: np.ndarray) -> bytes:
        import io as _io

        from PIL import Image

        buf = _io.BytesIO()
        Image.fromarray(gray.astype(np.uint8)).save(
            buf, format="JPEG", quality=self.jpeg_quality)
        return buf.getvalue()


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _to_host(*items):
    """Each item (None, numpy, or a tensor) as numpy.  Tensors on the CPU are
    viewed; the tensors on a CUDA device are packed into one float32 vector
    there and fetched in ONE copy (a single host wait), then split and cast
    back.  Every packed value is exact in float32: grey levels, pixel
    coordinates, 0/1 flags and the pose's own float32 entries."""
    out = list(items)
    on_card = [i for i, x in enumerate(items) if _on_card(x)]
    for i, x in enumerate(items):
        if isinstance(x, torch.Tensor) and i not in on_card:
            out[i] = x.numpy()
    if on_card:
        packed = torch.cat([items[i].reshape(-1).to(torch.float32)
                            for i in on_card]).cpu().numpy()
        off = 0
        for i in on_card:
            x = items[i]
            flat = packed[off:off + x.numel()]
            off += x.numel()
            dtype = bool if x.dtype == torch.bool else np.float32
            out[i] = flat.reshape(tuple(x.shape)).astype(dtype)
    return out
