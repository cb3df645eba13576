"""Minimal, dependency-free TensorBoard scalar event writer (the port's own
copy of ``pointcloud_style_transfer_tpu/utils/tensorboard.py``).

The trainer logs ``Loss/Train`` and ``Loss/Validation`` scalars. This module
writes TensorBoard's public on-disk format directly, so the port needs
neither ``tensorboard`` nor ``torch.utils.tensorboard``'s dependencies:

* an event file is a TFRecord stream: ``uint64 length (LE) | masked-crc32c
  of the length | payload | masked-crc32c of the payload``;
* each payload is a serialized ``tensorflow.Event`` protobuf. Only three
  fields are needed for scalars — ``wall_time`` (double, field 1), ``step``
  (int64, field 2) and ``summary`` (field 5) holding repeated
  ``Summary.Value`` entries with ``tag`` (string, field 1) and
  ``simple_value`` (float, field 2) — plus the ``file_version`` (string,
  field 3) header record TensorBoard requires ("brain.Event:2").
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

# --- crc32c (Castagnoli), table-driven; TFRecord framing requires it ------
_CRC_TABLE = []
_POLY = 0x82F63B78


def _make_table():
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- protobuf wire helpers -------------------------------------------------
def _varint(n: int) -> bytes:
    # Negative ints (e.g. a negative step) keep their sign bit under
    # Python's arithmetic >> and would loop forever; protobuf encodes
    # them as 64-bit two's complement.
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    summary_value = (_bytes_field(1, tag.encode("utf-8"))
                     + _float_field(2, float(value)))
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time) + _varint_field(2, int(step))
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class SummaryWriter:
    """Drop-in minimal replacement for
    ``torch.utils.tensorboard.SummaryWriter`` (scalars only)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        ts = time.time()
        host = socket.gethostname()
        self._path = os.path.join(
            log_dir, f"events.out.tfevents.{int(ts)}.{host}")
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write_record(_version_event(ts))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        rec = (header + struct.pack("<I", _masked_crc(header)) + payload
               + struct.pack("<I", _masked_crc(payload)))
        with self._lock:
            self._file.write(rec)
            self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()
