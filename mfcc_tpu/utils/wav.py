"""WAV IO: RIFF PCM reader/writer with a native C++ fast path.

Reader contract: 16-bit PCM (the baseline's input format) decodes to
float32 in [-1, 1) via x/32768; mono required for the feature pipeline
(multi-channel files expose a channel argument).  A malformed file raises
``WavError`` — per-utterance quarantine (skip + log, don't kill the pod
job) happens in the corpus runner (SURVEY.md §5 failure detection).

The pure-Python parser is the always-available fallback; ``native.wavio``
(C++, ctypes) decodes and converts in native code for corpus-scale
ingestion — the runtime-outside-the-compute-path component the reference
kept in C (its entire repo is C; SURVEY.md §2b maps native surface to
C++ for host IO).
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np


class WavError(ValueError):
    pass


_HDR = struct.Struct("<4sI4s")
_FMT = struct.Struct("<HHIIHH")


def read_wav(path: str | os.PathLike, channel: int | None = None):
    """Read a RIFF WAV file -> (float32 signal in [-1,1), sample_rate).

    Supports PCM16 (primary), PCM8/24/32 and float32 for completeness.
    Multi-channel: channel=None averages; channel=k selects.
    """
    native = _native()
    if native is not None and channel in (None, 0):
        try:
            return native.read_wav_native(os.fspath(path), -1 if channel is None else 0)
        except Exception:
            pass  # fall back to the Python parser for odd layouts
    with open(path, "rb") as f:
        return _parse(f.read(), channel)


def _parse(data: bytes, channel: int | None):
    if len(data) < 12:
        raise WavError("file too short for RIFF header")
    riff, _size, wave = _HDR.unpack_from(data, 0)
    if riff != b"RIFF" or wave != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid, csz = struct.unpack_from("<4sI", data, pos)
        pos += 8
        body = data[pos: pos + csz]
        if cid == b"fmt ":
            if csz < 16:
                raise WavError("fmt chunk too small")
            fmt = _FMT.unpack_from(body, 0)
        elif cid == b"data":
            payload = body
        pos += csz + (csz & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise WavError("missing fmt or data chunk")
    audio_format, n_ch, sr, _brate, _balign, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: subformat in ext
        audio_format = 1 if bits in (8, 16, 24, 32) else audio_format
    if audio_format == 1:  # integer PCM
        if bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(payload, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(payload, "u1").reshape(-1, 3)
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / 8388608.0
        else:
            raise WavError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(payload, "<f4").astype(np.float32)
    else:
        raise WavError(f"unsupported audio format {audio_format}/{bits}bit")
    if n_ch > 1:
        usable = (len(x) // n_ch) * n_ch
        x = x[:usable].reshape(-1, n_ch)
        x = x[:, channel] if channel is not None else x.mean(axis=1)
    return np.ascontiguousarray(x), sr


def wav_info(path: str | os.PathLike):
    """Header-only probe -> (n_samples, sample_rate) without decoding.

    Reads only the first few KB: enough for fmt + the data chunk header in
    any sanely-written WAV.  Used by the corpus runner to bucket by length
    before the (native, threaded) batch decode touches sample data.
    """
    with open(path, "rb") as f:
        head = f.read(65536)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(head):
        cid, csz = struct.unpack_from("<4sI", head, pos)
        pos += 8
        if cid == b"fmt " and csz >= 16:
            fmt = _FMT.unpack_from(head, pos)
        elif cid == b"data":
            if fmt is None:
                raise WavError("data chunk before fmt")
            _afmt, n_ch, sr, _br, _ba, bits = fmt
            n_ch = n_ch or 1
            bytes_per = max(bits // 8, 1)
            return csz // (bytes_per * n_ch), sr
        pos += csz + (csz & 1)
    raise WavError("missing fmt or data chunk")


def write_wav(path: str | os.PathLike, x: np.ndarray, sample_rate: int):
    """Write mono float [-1,1] (or int16) as PCM16 WAV (test fixtures)."""
    if x.dtype != np.int16:
        x = np.clip(np.asarray(x, np.float64), -1.0, 32767.0 / 32768.0)
        x = np.round(x * 32768.0).astype(np.int16)
    payload = x.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16)
                + _FMT.pack(1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


_NATIVE = None
_NATIVE_TRIED = False


def _native():
    """Lazy import of the C++ loader; None if the .so isn't built."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from ..native import wavio as _NATIVE  # noqa: F811
        except Exception:
            _NATIVE = None
    return _NATIVE
