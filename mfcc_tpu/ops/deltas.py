"""Delta / delta-delta features (JAX), padding-aware.

Standard regression deltas over the time axis:

    d[t] = sum_{n=1..D} n * (c[t+n] - c[t-n]) / (2 * sum n^2)

with *edge replication at the true utterance boundary*: for ragged batches
the neighbor index is clipped to [0, length-1] per utterance, so padded
frames never leak into the derivatives of real frames.  Implemented as a
static gather (indices depend only on shapes + lengths), which XLA fuses
into a handful of vector ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import FeatureConfig


def deltas(feat: jnp.ndarray, window: int = 2,
           lengths: jnp.ndarray | None = None) -> jnp.ndarray:
    """(..., T, F) -> (..., T, F) regression deltas.

    lengths: optional (...,) int array of true frame counts; neighbor
    indices are clipped to length-1 (edge replication at the ragged edge).
    Without lengths, edges replicate at 0 and T-1.
    """
    T = feat.shape[-2]
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    t = jnp.arange(T, dtype=jnp.int32)
    # Gather-free: the shift-and-clip indexing is edge-padded concat +
    # static slice (pure relayout); only the ragged end-edge needs the
    # per-utterance last valid frame — ONE (., 1, F) one-hot pick instead
    # of a (., T, F) take_along_axis.  The pick is pinned to HIGHEST: at
    # default precision a float32 contraction may run in TF32, which
    # would round the picked feature to ~1e-3 relative.
    if lengths is not None:
        hi_cap = jnp.maximum(lengths, 1).astype(jnp.int32) - 1  # (...,)
        onehot = (t == hi_cap[..., None]).astype(feat.dtype)    # (..., T)
        last = jnp.einsum("...t,...tf->...f", onehot, feat,
                          precision=jax.lax.Precision.HIGHEST)[..., None, :]
    out = jnp.zeros_like(feat)
    for n in range(1, window + 1):
        plus = jnp.concatenate(
            [feat[..., n:, :], jnp.repeat(feat[..., -1:, :], n, axis=-2)],
            axis=-2)
        minus = jnp.concatenate(
            [jnp.repeat(feat[..., :1, :], n, axis=-2), feat[..., :-n, :]],
            axis=-2)
        if lengths is not None:
            ragged_edge = (t + n)[:, None] > hi_cap[..., None, None]
            plus = jnp.where(ragged_edge, last, plus)
        out = out + n * (plus - minus)
    return out / jnp.asarray(denom, feat.dtype)


def append_deltas(feat: jnp.ndarray, cfg: FeatureConfig,
                  lengths: jnp.ndarray | None = None) -> jnp.ndarray:
    """(..., T, F) -> (..., T, 3F): [static, delta, delta-delta]."""
    d1 = deltas(feat, cfg.delta_window, lengths)
    d2 = deltas(d1, cfg.delta_window, lengths)
    return jnp.concatenate([feat, d1, d2], axis=-1)


class DeltaStream:
    """Streaming delta/delta-delta post-processor (host side).

    Batch deltas need a ±window halo, and ΔΔ needs a halo of Δ, so exact
    emission lags the static stream by 2*window frames.  This class
    buffers incoming static frames and emits [static, Δ, ΔΔ] rows that
    are *bit-identical to the batch computation's prefix* (start-edge
    replication included); only the final 2*window frames of a stream
    need :meth:`flush` (end-edge replication) once the source is done.

    Features are tiny (tens of floats/frame), so this runs in NumPy on
    the host next to the consumer — no device round-trips.
    """

    def __init__(self, window: int = 2):
        self.window = window
        self._buf = None          # retained frames (np.float64, (K, F))
        self._buf_start = 0       # global index of _buf[0]
        self._emitted = 0         # next global row to emit
        self._total = 0           # frames received
        self._at_start = True     # _buf[0] is the true stream start

    def _slice_deltas(self, lo: int, hi: int) -> np.ndarray:
        """Exact [static, Δ, ΔΔ] for global rows [lo, hi) using only
        retained frames; edge replication is genuine only at the true
        stream boundaries (interior slice edges have real ±2w context)."""
        import numpy as _np
        from .. import oracle
        w = self.window
        a = max(self._buf_start, lo - 2 * w)
        feat = self._buf[a - self._buf_start:]
        d1 = oracle.deltas(feat, w)
        d2 = oracle.deltas(d1, w)
        out = _np.concatenate([feat, d1, d2], axis=-1)
        return out[lo - a: hi - a]

    def push(self, static_frames: np.ndarray) -> np.ndarray:
        """Add (k, F) new static frames; returns all newly-final
        [static, Δ, ΔΔ] rows (possibly empty)."""
        import numpy as _np
        new = _np.asarray(static_frames, _np.float64).reshape(
            -1, static_frames.shape[-1])
        self._buf = new if self._buf is None else _np.concatenate(
            [self._buf, new])
        self._total += new.shape[0]
        w = self.window
        safe = self._total - 2 * w       # rows unaffected by future frames
        if safe <= self._emitted:
            return _np.zeros((0, new.shape[-1] * 3))
        out = self._slice_deltas(self._emitted, safe)
        self._emitted = safe
        # retain only what future rows can still reference: 4w frames back
        keep_from = max(self._buf_start, self._emitted - 4 * w)
        if self._at_start and self._emitted > 4 * w:
            self._at_start = False
        if not self._at_start:
            self._buf = self._buf[keep_from - self._buf_start:]
            self._buf_start = keep_from
        return out

    def flush(self) -> np.ndarray:
        """Emit the trailing 2*window rows (end edge now resolvable)."""
        import numpy as _np
        if self._buf is None or self._emitted >= self._total:
            return _np.zeros((0, 0))
        out = self._slice_deltas(self._emitted, self._total)
        self._emitted = self._total
        return out
