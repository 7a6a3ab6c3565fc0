"""tev image-viewer client (port of nn_bvh_tpu/utils/display.py).

Streams render progress to a running `tev` instance over its TCP protocol:
each packet is a little-endian uint32 length (the packet's own 4 bytes
included), a type byte, then the packet's fields (CreateImage,
UpdateImage per channel, CloseImage). `cli.render --display-server
host[:port]` sends one update a wave. Optional: a viewer that cannot be
reached is a warning on stderr, and the client then sends nothing.
"""

from __future__ import annotations

import socket
import struct
import sys

import numpy as np

_CREATE_IMAGE = 4
_UPDATE_IMAGE = 3
_CLOSE_IMAGE = 2


class TevDisplay:
    def __init__(self, host: str = "127.0.0.1", port: int = 14158):
        self.sock = None
        try:
            self.sock = socket.create_connection((host, port), timeout=1.0)
        except OSError as e:
            print(f"warning: tev display unavailable ({e})", file=sys.stderr)

    def _send(self, payload: bytes) -> None:
        if self.sock is None:
            return
        try:
            self.sock.sendall(struct.pack("<I", len(payload) + 4) + payload)
        except OSError:
            self.sock = None

    def create_image(self, name: str, width: int, height: int,
                     channels=("R", "G", "B")) -> None:
        p = struct.pack("<BB", _CREATE_IMAGE, 1)  # type, grabFocus
        p += name.encode() + b"\x00"
        p += struct.pack("<ii", width, height)
        p += struct.pack("<i", len(channels))
        for c in channels:
            p += c.encode() + b"\x00"
        self._send(p)

    def update_image(self, name: str, img: np.ndarray, x: int = 0, y: int = 0,
                     channels=("R", "G", "B")) -> None:
        """img: (h, w, 3) float32 tile at offset (x, y)."""
        img = np.asarray(img, np.float32)
        h, w = img.shape[:2]
        for ci, c in enumerate(channels):
            p = struct.pack("<BB", _UPDATE_IMAGE, 0)
            p += name.encode() + b"\x00"
            p += c.encode() + b"\x00"
            p += struct.pack("<iiii", x, y, w, h)
            p += np.ascontiguousarray(img[..., ci]).tobytes()
            self._send(p)

    def close_image(self, name: str) -> None:
        p = struct.pack("<B", _CLOSE_IMAGE) + name.encode() + b"\x00"
        self._send(p)

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None
