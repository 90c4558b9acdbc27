"""Dependency-free TensorBoard scalar writer.

The reference logs to TensorBoard via the `tensorboard_logger` package
(`mava/utils/logger.py:196-208`), which is not available in this image. Rather than
dropping the capability, this module writes tfevents files directly: scalar summaries
are hand-encoded in protobuf wire format and framed as TFRecords with masked CRC32C —
readable by any stock TensorBoard.
"""

from __future__ import annotations

import os
import struct
import time

# ---------------------------------------------------------------- crc32c (Castagnoli)
_CRC_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 * (_crc & 1))
    _CRC_TABLE.append(_crc)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf encoding
def _varint(value: int) -> bytes:
    out = b""
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out += bytes([bits | 0x80])
        else:
            out += bytes([bits])
            return out


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def _len_delim(field_number: int, payload: bytes) -> bytes:
    return _tag(field_number, 2) + _varint(len(payload)) + payload


def _double(field_number: int, value: float) -> bytes:
    return _tag(field_number, 1) + struct.pack("<d", value)


def _float(field_number: int, value: float) -> bytes:
    return _tag(field_number, 5) + struct.pack("<f", value)


def _int64(field_number: int, value: int) -> bytes:
    return _tag(field_number, 0) + _varint(value)


def _encode_scalar_event(tag_name: str, value: float, step: int) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    summary_value = _len_delim(1, tag_name.encode()) + _float(2, float(value))
    # Summary { value = 1 (repeated Value) }
    summary = _len_delim(1, summary_value)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 (Summary) }
    return _double(1, time.time()) + _int64(2, int(step)) + _len_delim(5, summary)


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TensorboardWriter:
    """Appends scalar events to a tfevents file in `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        filename = f"events.out.tfevents.{int(time.time())}.mava_jax"
        self._file = open(os.path.join(log_dir, filename), "ab")
        # TensorBoard requires a leading file-version event.
        version = _double(1, time.time()) + _len_delim(3, b"brain.Event:2")
        self._file.write(_tfrecord(version))
        self._file.flush()

    def scalar(self, tag_name: str, value: float, step: int) -> None:
        self._file.write(_tfrecord(_encode_scalar_event(tag_name, value, step)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.flush()
        self._file.close()
