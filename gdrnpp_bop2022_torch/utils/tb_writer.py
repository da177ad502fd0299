"""Dependency-free TensorBoard scalar writer.

The port's copy of ``gdrnpp_bop2022_tpu/utils/tb_writer.py`` (pure Python;
the port imports nothing of the JAX package).

The reference streams metrics to tensorboardX (core/utils/my_writer.py:53
MyTensorboardXWriter); neither tensorboard nor tensorboardX is a
dependency here, so the event-file format is written directly: TFRecord
framing (length + masked crc32c + payload + masked crc32c) around
hand-encoded `Event` protobufs (wall_time=1:double, step=2:int64,
file_version=3:string, summary=5: {value=1: {tag=1:string,
simple_value=2:float}}). Scalars only — images stay as png grid dumps.
"""

from __future__ import annotations

import os
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_string(num: int, s: bytes) -> bytes:
    return _field(num, 2) + _varint(len(s)) + s


def _pb_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _pb_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _pb_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _event(step: int = 0, wall_time: float = None, file_version: str = None,
           scalars: dict = None, images: dict = None) -> bytes:
    msg = _pb_double(1, wall_time if wall_time is not None else time.time())
    msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_string(3, file_version.encode())
    values = b""
    if scalars:
        values += b"".join(
            _pb_string(1, _pb_string(1, tag.encode()) + _pb_float(2, float(v)))
            for tag, v in scalars.items())
    if images:
        for tag, (h, w, png) in images.items():
            img_msg = (_pb_varint(1, h) + _pb_varint(2, w)
                       + _pb_varint(3, 3)              # colorspace RGB
                       + _pb_string(4, png))
            values += _pb_string(1, _pb_string(1, tag.encode())
                                 + _pb_string(4, img_msg))
    if values:
        msg += _pb_string(5, values)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TensorBoardWriter:
    """Minimal SummaryWriter: scalars into a tfevents file under logdir."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: dict, step: int):
        self._f.write(_record(_event(step=step, scalars=scalars)))

    def add_image(self, tag: str, img, step: int):
        """img: (H, W, 3) uint8 RGB (reference: TB train-image/xyz/mask
        dumps, my_writer.py:53 + engine.py:371-397)."""
        import cv2
        import numpy as np
        img = np.asarray(img)
        ok, png = cv2.imencode(".png", img[..., ::-1])   # RGB -> BGR
        assert ok
        self._f.write(_record(_event(
            step=step,
            images={tag: (img.shape[0], img.shape[1], png.tobytes())})))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_events(path: str):
    """Parse a tfevents file back into [(step, {tag: value})] — used by
    tests and handy for quick inspection without tensorboard installed."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        assert hcrc == _masked_crc(data[i:i + 8]), "corrupt header crc"
        payload = data[i + 12: i + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + length)
        assert pcrc == _masked_crc(payload), "corrupt payload crc"
        i += 12 + length + 4
        step, scalars = 0, {}
        j = 0
        while j < len(payload):
            key = payload[j]
            num, wire = key >> 3, key & 7
            j += 1
            if wire == 1:
                j += 8
            elif wire == 5:
                j += 4
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[j]
                    v |= (b & 0x7F) << shift
                    shift += 7
                    j += 1
                    if not b & 0x80:
                        break
                if num == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[j]
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    j += 1
                    if not b & 0x80:
                        break
                sub = payload[j:j + ln]
                j += ln
                if num == 5:     # summary
                    k = 0
                    while k < len(sub):
                        assert sub[k] == (1 << 3) | 2
                        k += 1
                        vl = 0
                        shift = 0
                        while True:
                            b = sub[k]
                            vl |= (b & 0x7F) << shift
                            shift += 7
                            k += 1
                            if not b & 0x80:
                                break
                        val = sub[k:k + vl]
                        k += vl
                        tag, sv = None, None
                        m = 0
                        while m < len(val):
                            kk = val[m]
                            m += 1
                            if kk == (1 << 3) | 2:
                                tl = val[m]
                                m += 1
                                tag = val[m:m + tl].decode()
                                m += tl
                            elif kk == (2 << 3) | 5:
                                (sv,) = struct.unpack_from("<f", val, m)
                                m += 4
                            else:
                                break
                        if tag is not None and sv is not None:
                            scalars[tag] = sv
        if scalars:
            out.append((step, scalars))
    return out
