"""Sample-rate conversion as ONE GEMM (polyphase resampler).

Production corpora are not uniformly 16 kHz; a front-end that quarantines
every 8/22.05/44.1/48 kHz file (the round-1 behavior) is incomplete.  This
module provides rational-ratio resampling (upsample L, Kaiser-windowed-sinc
lowpass, downsample M) in the same GEMM-native style as the DFT stage:

    y[b*L + p] = dot(x[b*M + lo : b*M + lo + W], H[:, p])

i.e. the polyphase filter bank is laid out as a single (W, L) matrix H and
the signal as overlapping width-W frames strided by M — the same zero-copy
hop-block concat the spectral stage uses, so the whole resampler is one
matmul per signal.  No scalar loops, no dynamic
shapes, no scatter.

Filter design matches scipy.signal.resample_poly's default: a Kaiser
(beta 5.0) windowed sinc with 10*max(L, M) taps per side, cutoff at the
lower of the two Nyquists, DC gain exactly L after normalization; edges
are zero-padded and group delay is removed, so y[j] estimates x(j*M/L)
and len(y) = ceil(n*L/M).  Cross-checked against scipy in
tests/test_resample.py; the float64 NumPy twin (`resample_poly_numpy`) is
the oracle and the host-side fallback used by the corpus runner.

Reference analog: the reference compiler rejects any input it cannot
tokenize by exiting (/root/reference/src/mfcc/main.c:73-82); a feature
framework must instead convert foreign-but-valid inputs to the contract
rate (SURVEY.md §5 failure-handling: quarantine only what is *corrupt*).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from .spectrum import _frames_by_concat


def reduce_ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    """(L, M) in lowest terms with sr_out = sr_in * L / M."""
    g = math.gcd(int(sr_in), int(sr_out))
    return int(sr_out) // g, int(sr_in) // g


def resampled_length(n: int, sr_in: int, sr_out: int) -> int:
    """Output sample count: ceil(n * L / M) (scipy convention)."""
    L, M = reduce_ratio(sr_in, sr_out)
    return -(-n * L // M)


@functools.lru_cache(maxsize=32)
def _kaiser_sinc(L: int, M: int) -> np.ndarray:
    """Float64 anti-alias/interpolation FIR, scipy-compatible design:
    half length 10*max(L, M), Kaiser beta 5.0, cutoff 1/max(L, M) of the
    upsampled Nyquist, normalized to DC gain 1 then scaled by L (the
    upsampler's energy loss)."""
    max_lm = max(L, M)
    half = 10 * max_lm
    taps = 2 * half + 1
    m = np.arange(taps, dtype=np.float64) - half
    fc = 1.0 / max_lm
    h = fc * np.sinc(fc * m) * np.kaiser(taps, 5.0)
    return h * (L / h.sum())


@functools.lru_cache(maxsize=32)
def _polyphase_matrix(L: int, M: int) -> tuple[np.ndarray, int]:
    """(H (W, L) float64, lo): y[b*L + p] = dot(x[b*M+lo : b*M+lo+W], H[:, p]).

    Derivation: with u the L-upsampled signal and half the filter center,
    y[j] = sum_i h[i] u[j*M - i + half]; nonzero u terms need
    i = t*L + rho_p with rho_p = (p*M + half) mod L (j = b*L + p), giving
    x indices b*M + q_p - t, q_p = (p*M + half - rho_p) / L.  Each output
    phase p is therefore a dot of K_p = ceil((taps - rho_p)/L) filter taps
    with a contiguous input slice; stacking all L phases over their joint
    index range [lo, lo+W) yields one dense matrix.
    """
    h = _kaiser_sinc(L, M)
    taps = h.shape[0]
    half = (taps - 1) // 2
    p = np.arange(L)
    rho = (p * M + half) % L
    q = (p * M + half - rho) // L
    K = -(-(taps - rho) // L)
    lo = int((q - (K - 1)).min())
    W = int(q.max()) - lo + 1
    H = np.zeros((W, L), np.float64)
    for pp in range(L):
        t = np.arange(K[pp])
        H[q[pp] - t - lo, pp] = h[t * L + rho[pp]]
    return H, lo


def _frame_geometry(n: int, L: int, M: int, W: int, lo: int):
    """Shared jax/numpy bookkeeping: output/block counts and edge pads."""
    n_out = -(-n * L // M)
    nb = -(-n_out // L)                      # output blocks of L samples
    pad_l = max(0, -lo)
    start0 = lo + pad_l                      # first frame offset into xp
    need = (nb - 1) * M + start0 + W         # past-the-end input index
    return n_out, nb, pad_l, start0, need


def resample_poly_numpy(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Float64 host twin (oracle + corpus-runner fallback).  1-D input."""
    if sr_in == sr_out:
        return np.asarray(x, np.float64).copy()
    L, M = reduce_ratio(sr_in, sr_out)
    H, lo = _polyphase_matrix(L, M)
    W = H.shape[0]
    n = x.shape[-1]
    n_out, nb, pad_l, start0, need = _frame_geometry(n, L, M, W, lo)
    if n_out == 0 or n == 0:
        return np.zeros((0,), np.float64)
    xp = np.pad(np.asarray(x, np.float64), (pad_l, max(0, need - n)))
    idx = (np.arange(nb) * M + start0)[:, None] + np.arange(W)[None, :]
    return (xp[idx] @ H).reshape(-1)[:n_out]


def resample(x: jnp.ndarray, sr_in: int, sr_out: int, *,
             precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """(..., n) float audio at sr_in -> (..., ceil(n*L/M)) at sr_out.

    Jit-friendly: static shapes, one GEMM (frames built by the same
    static-slice concat as the spectral stage — no gather).  Float32 at
    HIGHEST matmul precision: measured ~1e-7 vs the float64 twin on
    unit-range audio, far inside the 1e-4 feature contract.
    """
    if sr_in == sr_out:
        return x
    L, M = reduce_ratio(sr_in, sr_out)
    H, lo = _polyphase_matrix(L, M)
    W = H.shape[0]
    n = x.shape[-1]

    # Super-block the polyphase bank so the GEMM has >= ~128 output
    # columns.  For small L (e.g. 16k->4k has L=1) the naive (W, L)
    # matrix is a matrix-vector product with 1..L output columns.  Stacking R decimation steps per GEMM row
    # (block-Toeplitz H2: column r*L+p = H[:, p] shifted r*M rows) is the
    # SAME per-output dot product — the band's structural zeros add
    # exact 0.0 terms — so outputs are bit-identical, with R*L lanes
    # live.  Geometry below is unchanged under (L, M, W, H) ->
    # (R*L, R*M, (R-1)*M + W, H2).
    R = max(1, -(-128 // L))
    if R > 1:
        W2 = (R - 1) * M + W
        H2 = np.zeros((W2, R * L), H.dtype)
        for r in range(R):
            H2[r * M: r * M + W, r * L: (r + 1) * L] = H
        L, M, W, H = R * L, R * M, W2, H2

    n_out, nb, pad_l, start0, need = _frame_geometry(n, L, M, W, lo)
    if n_out == 0 or n == 0:
        return jnp.zeros((*x.shape[:-1], 0), jnp.float32)
    x = x.astype(jnp.float32)
    pad = [(0, 0)] * (x.ndim - 1) + [(pad_l, max(0, need - n))]
    xp = jnp.pad(x, pad)[..., start0:]
    n_blocks = -(-W // M)
    frames = _frames_by_concat(xp, M, nb, n_blocks)      # (..., nb, nbk*M)
    Hp = np.zeros((n_blocks * M, L), np.float32)
    Hp[:W] = H
    y = jnp.matmul(frames, jnp.asarray(Hp), precision=precision)
    return y.reshape(*x.shape[:-1], nb * L)[..., :n_out]


resample_jit = jax.jit(resample, static_argnames=("sr_in", "sr_out",
                                                  "precision"))


class StreamingResampler:
    """Host-side chunked twin of :func:`resample_poly_numpy`.

    Emits exactly the batch resampler's output prefix as raw samples
    arrive: output block b (L samples) needs raw samples
    [b*M + lo, b*M + lo + W), so a block is emitted once its full input
    window has been seen; :meth:`flush` zero-pads the tail (the batch
    edge convention) and emits the remainder so that the concatenation
    of every chunk equals ``resample_poly_numpy(whole_signal)`` to f64
    roundoff (~1e-16; BLAS blocking order differs with the emitted block
    count — tests/test_resample.py).  Used by the online pitch tracker;
    pure NumPy (feature-rate signals are tiny next to decode).
    """

    def __init__(self, sr_in: int, sr_out: int):
        if sr_in == sr_out:
            raise ValueError("no-op resampler; stream the samples directly")
        self.L, self.M = reduce_ratio(sr_in, sr_out)
        self.H, lo = _polyphase_matrix(self.L, self.M)
        self.W = self.H.shape[0]
        self.pad_l = max(0, -lo)
        self.start0 = lo + self.pad_l       # first frame offset into xp
        # xp = [pad_l zeros | raw]; keep only the suffix still needed
        self._buf = np.zeros((self.pad_l,), np.float64)
        self._buf_start = 0                 # xp index of _buf[0]
        self._n_raw = 0                     # raw samples received
        self._blocks_done = 0
        self._flushed = False

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Raw samples in -> every newly complete output sample out."""
        assert not self._flushed, "feed after flush"
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, np.float64)])
        self._n_raw += len(chunk)
        xp_len = self.pad_l + self._n_raw
        # blocks b with b*M + start0 + W <= xp_len are complete
        nb_ready = max((xp_len - self.start0 - self.W) // self.M + 1, 0)
        return self._emit(nb_ready)

    def flush(self) -> np.ndarray:
        """Zero-pad the tail and emit the remaining output samples so the
        total output length is ceil(n_raw * L / M) (batch convention)."""
        assert not self._flushed
        self._flushed = True
        n_out, nb, _pad_l, start0, need = _frame_geometry(
            self._n_raw, self.L, self.M, self.W, self.start0 - self.pad_l)
        xp_len = self.pad_l + self._n_raw
        self._buf = np.concatenate(
            [self._buf, np.zeros((max(0, need + self.pad_l - xp_len),))])
        return self._emit(nb)  # exact-length trim happens in _emit

    def _emit(self, nb_ready: int) -> np.ndarray:
        bs = np.arange(self._blocks_done, nb_ready)
        if bs.size == 0:
            return np.zeros((0,), np.float64)
        idx = (bs * self.M + self.start0 - self._buf_start)[:, None] \
            + np.arange(self.W)[None, :]
        y = (self._buf[idx] @ self.H).reshape(-1)
        self._blocks_done = nb_ready
        # trim the final partial block to the exact output length
        if self._flushed:
            n_out = -(-self._n_raw * self.L // self.M)
            y = y[: n_out - (bs[0] * self.L)]
        # drop buffer prefix no longer reachable by future blocks
        keep_from = nb_ready * self.M + min(self.start0, 0)
        drop = max(keep_from - self._buf_start, 0)
        drop = min(drop, self._buf.shape[0])
        self._buf = self._buf[drop:]
        self._buf_start += drop
        return y
