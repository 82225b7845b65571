"""Scoped TensorBoard summaries with a dependency-free event writer.

TPU-native replacement for the reference summary machinery
(reference: adanet/core/summary.py:41-973). The reference monkey-patches
`tf.summary` and buffers (fn, tensor) tuples through TPU host calls; here
metrics are plain host-side floats fetched from jitted steps, and this
module provides:

- `EventFileWriter`: a minimal, dependency-free writer of TensorBoard
  `tfevents` files (TFRecord framing + hand-encoded Event/Summary protos +
  masked CRC32C), the "own event-file writer" equivalent of TF's native
  summary writer (reference relies on TF's C++ EventsWriter). Supports
  the full reference `Summary` ABC surface — scalar, image, histogram,
  audio (reference: adanet/core/summary.py:41-199) — with stdlib-only
  PNG (zlib) and WAV encoders.
- `ScopedSummary`: namespaces writers per candidate so identically-named
  metrics from different candidates chart together in TensorBoard
  (reference: adanet/core/summary.py:213-373, docs/source/tensorboard.md).
"""

from __future__ import annotations

import math
import os
import socket
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

# ----------------------------------------------------------------- CRC32C

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
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_double(number: int, value: float) -> bytes:
    return _varint((number << 3) | 1) + struct.pack("<d", value)


def _field_float(number: int, value: float) -> bytes:
    return _varint((number << 3) | 5) + struct.pack("<f", value)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _field_bytes(number: int, data: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(data)) + data


def _packed_doubles(number: int, values) -> bytes:
    data = b"".join(struct.pack("<d", float(v)) for v in values)
    return _field_bytes(number, data)


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float).
    return _field_bytes(1, tag.encode()) + _field_float(2, float(value))


def _encode_png(image) -> Optional[tuple]:
    """Encodes HxW[xC] arrays as PNG (stdlib zlib; filter 0 scanlines).

    Floats in [0, 1] are scaled to [0, 255] (the tf.summary.image float
    convention); other numerics are clipped to uint8 range. Returns
    (png_bytes, height, width, channels) or None for unusable shapes.
    """
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in (1, 2, 3, 4):
        return None
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float64)
        finite = np.isfinite(arr)
        arr = np.where(finite, arr, 0.0)
        if arr.size and np.all(arr[finite] <= 1.0) and np.all(
            arr[finite] >= 0.0
        ):
            arr = arr * 255.0
        arr = np.clip(arr, 0.0, 255.0).astype(np.uint8)
    height, width, channels = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(height))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    return png, height, width, channels


def _image_value(tag: str, image) -> Optional[bytes]:
    encoded = _encode_png(image)
    if encoded is None:
        return None
    png, height, width, channels = encoded
    # Summary.Image: height=1, width=2, colorspace=3,
    # encoded_image_string=4. Colorspace 1=gray, 2=gray+alpha, 3=RGB,
    # 4=RGBA (summary.proto).
    colorspace = {1: 1, 2: 2, 3: 3, 4: 4}[channels]
    msg = (
        _field_varint(1, height)
        + _field_varint(2, width)
        + _field_varint(3, colorspace)
        + _field_bytes(4, png)
    )
    value = _field_bytes(1, tag.encode()) + _field_bytes(4, msg)
    return _field_bytes(1, value)  # repeated Summary.value entry


def _histogram_value(tag: str, values, bins: int = 30) -> Optional[bytes]:
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    counts, edges = np.histogram(v, bins=min(bins, max(1, v.size)))
    # HistogramProto: min=1, max=2, num=3, sum=4, sum_squares=5,
    # bucket_limit=6 (packed), bucket=7 (packed). bucket_limit[i] is the
    # right edge of bucket i (histogram.proto).
    msg = (
        _field_double(1, float(v.min()))
        + _field_double(2, float(v.max()))
        + _field_double(3, float(v.size))
        + _field_double(4, float(v.sum()))
        + _field_double(5, float(np.square(v).sum()))
        + _packed_doubles(6, edges[1:])
        + _packed_doubles(7, counts)
    )
    # Summary.Value.histo is field 5 (field 7 is node_name).
    value = _field_bytes(1, tag.encode()) + _field_bytes(5, msg)
    return _field_bytes(1, value)  # repeated Summary.value entry


def _encode_wav(audio, sample_rate: int) -> Optional[tuple]:
    """Encodes [frames] or [frames, channels] float in [-1, 1] (or int16)
    as a PCM16 WAV. Returns (wav_bytes, num_channels, length_frames)."""
    arr = np.asarray(audio)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2 or arr.shape[0] == 0:
        return None
    if arr.dtype != np.int16:
        arr = np.where(np.isfinite(arr), arr, 0.0)
        arr = (np.clip(arr.astype(np.float64), -1.0, 1.0) * 32767.0).astype(
            np.int16
        )
    frames, channels = arr.shape
    data = arr.tobytes()
    byte_rate = sample_rate * channels * 2
    header = (
        b"RIFF"
        + struct.pack("<I", 36 + len(data))
        + b"WAVEfmt "
        + struct.pack(
            "<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
            channels * 2, 16,
        )
        + b"data"
        + struct.pack("<I", len(data))
    )
    return header + data, channels, frames


def _audio_value(tag: str, audio, sample_rate: int) -> Optional[bytes]:
    encoded = _encode_wav(audio, sample_rate)
    if encoded is None:
        return None
    wav, channels, frames = encoded
    # Summary.Audio: sample_rate=1 (float), num_channels=2,
    # length_frames=3, encoded_audio_string=4, content_type=5.
    msg = (
        _field_float(1, float(sample_rate))
        + _field_varint(2, channels)
        + _field_varint(3, frames)
        + _field_bytes(4, wav)
        + _field_bytes(5, b"audio/wav")
    )
    value = _field_bytes(1, tag.encode()) + _field_bytes(6, msg)
    return _field_bytes(1, value)  # repeated Summary.value entry


def _event(
    wall_time: float,
    step: int,
    file_version: Optional[str] = None,
    scalars: Optional[Dict[str, float]] = None,
    raw_values: Optional[list] = None,
) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3 (string),
    # summary=5 (Summary message with repeated value=1).
    out = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    summary = b""
    if scalars:
        summary += b"".join(
            _field_bytes(1, _summary_value(tag, value))
            for tag, value in scalars.items()
        )
    if raw_values:
        summary += b"".join(raw_values)
    if summary:
        out += _field_bytes(5, summary)
    return out


# ------------------------------------------------------------ event writer


class EventFileWriter:
    """Appends Event records to an `events.out.tfevents.*` file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        filename = "events.out.tfevents.%d.%s" % (
            int(time.time()),
            socket.gethostname(),
        )
        self._path = os.path.join(logdir, filename)
        self._file = open(self._path, "ab")
        self._write_record(
            _event(time.time(), 0, file_version="brain.Event:2")
        )
        self.flush()

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, data: bytes) -> None:
        # TFRecord framing: len, masked_crc(len), data, masked_crc(data).
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", _masked_crc(data)))

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        clean = {}
        for tag, value in scalars.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            if math.isfinite(value):
                clean[tag] = value
        if clean:
            self._write_record(_event(time.time(), int(step), scalars=clean))

    def add_image(self, tag: str, image, step: int) -> None:
        """Writes an HxW[xC] array as a PNG image summary (C in 1..4);
        floats in [0,1] are scaled like tf.summary.image."""
        value = _image_value(tag, image)
        if value is not None:
            self._write_record(
                _event(time.time(), int(step), raw_values=[value])
            )

    def add_histogram(self, tag: str, values, step: int) -> None:
        """Writes a histogram summary of the (flattened) array values."""
        value = _histogram_value(tag, values)
        if value is not None:
            self._write_record(
                _event(time.time(), int(step), raw_values=[value])
            )

    def add_audio(
        self, tag: str, audio, sample_rate: int, step: int
    ) -> None:
        """Writes [frames] or [frames, channels] audio as a WAV summary."""
        value = _audio_value(tag, audio, sample_rate)
        if value is not None:
            self._write_record(
                _event(time.time(), int(step), raw_values=[value])
            )

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self.flush()
            self._file.close()


class ScopedSummary:
    """Per-candidate namespaced writers under a common logdir.

    Metrics for candidate X land in `<logdir>/<namespace>/<X>/` with
    unscoped tags, so TensorBoard overlays the same metric across
    candidates — the reference's `_ScopedSummary` behavior
    (reference: adanet/core/summary.py:213-373).
    """

    def __init__(self, logdir: str):
        self._logdir = logdir
        self._writers: Dict[str, EventFileWriter] = {}

    def writer(self, namespace: str, scope: Optional[str] = None):
        key = os.path.join(namespace, scope) if scope else namespace
        if key not in self._writers:
            self._writers[key] = EventFileWriter(
                os.path.join(self._logdir, key)
            )
        return self._writers[key]

    def scalar(
        self, namespace: str, scope: Optional[str], tag: str, value, step: int
    ) -> None:
        self.writer(namespace, scope).add_scalars({tag: value}, step)

    def scalars(
        self, namespace: str, scope: Optional[str], values: Dict[str, float], step: int
    ) -> None:
        self.writer(namespace, scope).add_scalars(values, step)

    def image(
        self, namespace: str, scope: Optional[str], tag: str, image, step: int
    ) -> None:
        self.writer(namespace, scope).add_image(tag, image, step)

    def histogram(
        self, namespace: str, scope: Optional[str], tag: str, values, step: int
    ) -> None:
        self.writer(namespace, scope).add_histogram(tag, values, step)

    def audio(
        self,
        namespace: str,
        scope: Optional[str],
        tag: str,
        audio,
        sample_rate: int,
        step: int,
    ) -> None:
        self.writer(namespace, scope).add_audio(tag, audio, sample_rate, step)

    def flush(self) -> None:
        for writer in self._writers.values():
            writer.flush()

    def close(self) -> None:
        for writer in self._writers.values():
            writer.close()
        self._writers.clear()
