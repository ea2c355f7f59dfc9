"""Minimal TensorBoard scalar-event writer (pure Python, no TF dependency).

The port's own copy of e2fgvi_tpu/utils/tb.py, byte for byte the same
records. Replaces the reference's torch SummaryWriter usage
(core/trainer.py:83-91, 161-168) where tensorboard is absent. Writes the
standard
`events.out.tfevents.*` record format: length-prefixed protobuf Event
records with masked-CRC32C framing, scalars as `summary.value{tag,
simple_value}`. Readable by any TensorBoard.
"""

import os
import struct
import time


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


class SummaryWriter:
    """Scalar-only TensorBoard writer with the SummaryWriter add_scalar API."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.e2fgvi_tpu_torch"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_event(_double_field(1, time.time()) +
                          _bytes_field(3, b"brain.Event:2"))

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        # summary.Value{tag=1, simple_value=2}
        val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
        summary = _bytes_field(1, val)
        event = (_double_field(1, time.time()) + _int_field(2, int(step)) +
                 _bytes_field(5, summary))
        self._write_event(event)

    def close(self):
        self._f.close()
