"""Telemetry network transports: HTTP POST + one-shot WebSocket sinks.

The reference recorder uploads 1 Hz GNSS+IMU JSON two ways
(`sensor_recorder.cpp:321-472`): a cURL HTTP POST (success = HTTP 201,
Content-Type application/json, `sendJsonPayload` :353-407) and a
connect→handshake→write→close Boost.Beast WebSocket (`uploadJsonByWebSocket`
:321-350). Both are reproduced here dependency-free (urllib / raw RFC 6455
over a socket) as pluggable sinks for
:class:`fastliosam_tpu_torch.runtime.recorder.SensorRecorder`.

Zero-egress by default: nothing in this module is instantiated unless the
user configures a sink, and the recorder's default sink stays local JSONL.

The port's own copy of ``fastliosam_tpu/runtime/telemetry.py`` (the
stdlib only).
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import urllib.request
import uuid


def make_envelope(payload: dict, sender: str = "gnss_imu_sensor") -> dict:
    """Wrap a telemetry record in the reference's message envelope
    (`sensor_recorder.cpp:421-428`)."""
    return {
        "message_id": str(uuid.uuid4()),
        "message_type": "GNSS_IMU_DATA",
        "sender": sender,
        "message": {
            "timestamp": int(round(payload.get("timestamp", 0.0))),
            "gnss_data": payload.get("gnss"),
            "imu_data": payload.get("imu"),
        },
    }


class HttpSink:
    """POST each telemetry payload as JSON (`sendJsonPayload` analog).

    Success is a 2xx status (the reference checks for 201). Failures are
    counted, never raised — telemetry must not take down the recorder.
    """

    def __init__(self, url: str, timeout: float = 2.0, envelope: bool = True):
        self.url = url
        self.timeout = timeout
        self.envelope = envelope
        self.sent = 0
        self.failed = 0
        self.last_status: int | None = None

    def __call__(self, payload: dict):
        body = json.dumps(
            make_envelope(payload) if self.envelope else payload
        ).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                self.last_status = resp.status
                if 200 <= resp.status < 300:
                    self.sent += 1
                else:  # pragma: no cover
                    self.failed += 1
        except Exception:
            self.failed += 1


_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_handshake(sock: socket.socket, host: str, endpoint: str):
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {endpoint} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    )
    sock.sendall(req.encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("WebSocket handshake: connection closed")
        resp = resp + chunk
    head = resp.split(b"\r\n\r\n", 1)[0].decode(errors="replace")
    if "101" not in head.split("\r\n", 1)[0]:
        raise ConnectionError(f"WebSocket handshake rejected: {head}")
    expect = base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    ).decode()
    for line in head.split("\r\n")[1:]:
        if line.lower().startswith("sec-websocket-accept:"):
            if line.split(":", 1)[1].strip() != expect:
                raise ConnectionError("WebSocket handshake: bad accept key")
            return
    raise ConnectionError("WebSocket handshake: missing accept header")


def _ws_frame(opcode: int, payload: bytes) -> bytes:
    """A single client->server frame (FIN set, masked per RFC 6455 §5.3)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    mask = os.urandom(4)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return head + mask + masked


class WebSocketSink:
    """One-shot WebSocket upload per payload (`uploadJsonByWebSocket`
    analog): connect, handshake, send one text frame, close frame, close —
    exactly the reference's per-message lifecycle."""

    def __init__(self, host: str, port: int, endpoint: str = "/ws",
                 timeout: float = 2.0, envelope: bool = True):
        self.host = host
        self.port = port
        self.endpoint = endpoint
        self.timeout = timeout
        self.envelope = envelope
        self.sent = 0
        self.failed = 0

    def __call__(self, payload: dict):
        body = json.dumps(
            make_envelope(payload) if self.envelope else payload
        ).encode()
        try:
            with socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            ) as sock:
                _ws_handshake(sock, self.host, self.endpoint)
                sock.sendall(_ws_frame(0x1, body))  # text
                sock.sendall(_ws_frame(0x8, b""))  # close
                self.sent += 1
        except Exception:
            self.failed += 1


def multi_sink(*sinks):
    """Fan a telemetry payload out to several sinks (e.g. local JSONL +
    HTTP + WebSocket, like the reference writes the file AND uploads)."""

    def sink(payload: dict):
        for s in sinks:
            s(payload)

    return sink
