"""Pitch compute stages (NCCF + Viterbi, Kaldi-style).

The tracker follows Ghahremani et al. 2014 ("A pitch extraction algorithm
tuned for ASR", the Kaldi pitch) in structure; exact conventions are ours
and live in docs/conventions.md, mirrored stage-for-stage by the float64
oracle (oracle.pitch).

Device mapping (frames -> per-frame evidence, realized as GEMMs, not
scalar loops):

- lowpass + decimate to the work rate: the existing polyphase resampler
  (one GEMM; its Kaiser anti-alias filter IS the pitch lowpass).
- NCCF numerator for ALL lags at once via the correlation theorem on a
  GEMM-native real DFT: num = Re[conj(DFT(A)) * DFT(E)] -> IDFT at the
  lag grid.  Three constant-folded matrix products per frame block, no
  (T, n_lags, window) gather materialization (that tensor would be
  ~1.8 GB for a 64 x 10 s batch; the spectra are ~45 MB).
- window energies via one cumulative sum + static slices.
- Viterbi smoothing over the log-spaced lag grid as a ``lax.scan`` with
  an (n_lags, n_lags) transition-cost matrix; backtrace is a second
  reversed scan.  All shapes static; batch via ``vmap``.

Padded (ragged-batch) frames get their NCCF masked to exactly 0 before
the Viterbi pass: a flat-zero emission makes staying in the current
state free and optimal, so the padded tail provably never changes the
path through the valid region (transition costs are >= 0 with equality
only on the diagonal).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import backend as backend_lib
from ..config import PitchConfig
from . import deltas as deltas_op
from .resample import resample, reduce_ratio


# --------------------------------------------------------------------------
# Constant-folded matrices (float64 construction)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _corr_matrices(pcfg: PitchConfig):
    """DFT/IDFT matrices for the NCCF correlation theorem.

    n = frame_len_w + max_lag samples per extended window; Nc = n (the
    lag range 0..max_lag never wraps a length-n circular correlation
    because j + L <= n - 1 for j < frame_len_w).  K = Nc//2 + 1 real
    bins; the IDFT lands directly on the min_lag..max_lag grid with the
    1/Nc and the 2x interior-bin weights folded in.
    """
    n = pcfg.frame_len_w + pcfg.max_lag
    Nc = n + (n % 2)                       # even, so bin Nc/2 is real
    K = Nc // 2 + 1
    j = np.arange(Nc, dtype=np.float64)[:, None]
    k = np.arange(K, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / Nc
    cos_m = np.cos(ang)                    # (Nc, K)
    sin_m = np.sin(ang)
    wk = np.full((K,), 2.0)
    wk[0] = 1.0
    if Nc % 2 == 0:
        wk[-1] = 1.0
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1, dtype=np.float64)
    angL = 2.0 * np.pi * k.T * lags[None, :] / Nc   # (K, n_lags)
    cl = (wk[:, None] * np.cos(angL)) / Nc
    sl = (wk[:, None] * np.sin(angL)) / Nc
    f32 = np.float32
    return (n, Nc, cos_m.astype(f32), sin_m.astype(f32),
            cl.astype(f32), sl.astype(f32))


@functools.lru_cache(maxsize=16)
def _trans_matrix(pcfg: PitchConfig) -> np.ndarray:
    """(n_lags, n_lags) Viterbi transition costs penalty * dlog(lag)^2."""
    lags = np.arange(pcfg.min_lag, pcfg.max_lag + 1, dtype=np.float64)
    d = np.log(lags)[:, None] - np.log(lags)[None, :]
    return (pcfg.penalty * d * d).astype(np.float32)


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def work_lengths(lengths: jnp.ndarray, pcfg: PitchConfig) -> jnp.ndarray:
    """True work-rate sample counts: ceil(len * L / M) (resampler
    convention)."""
    L, M = reduce_ratio(pcfg.sample_rate, pcfg.work_rate)
    return (lengths.astype(jnp.int32) * L + (M - 1)) // M


def pitch_frame_counts(lengths: jnp.ndarray, pcfg: PitchConfig) -> jnp.ndarray:
    nw = work_lengths(lengths, pcfg)
    n = (nw - (pcfg.frame_len_w + pcfg.max_lag)) // pcfg.hop_len_w + 1
    return jnp.maximum(n, 0).astype(jnp.int32)


def nccf(xw: jnp.ndarray, pcfg: PitchConfig, mask: jnp.ndarray, *,
         precision=jax.lax.Precision.HIGHEST, ball=None):
    """(B, Nw) work-rate signal -> (nccf_ballasted, nccf_plain), each
    (B, T, n_lags).  mask: (B, T) frame validity (for the masked mean
    energy the ballast scales with).  ``ball``: optional (B,) precomputed
    ballast (pcfg.ballast * mean_energy^2) overriding the in-function
    masked mean — used by the chunked long-form path, where the ballast
    must be the GLOBAL signal mean, not the per-chunk mean."""
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    n, Nc, cos_m, sin_m, cl, sl = _corr_matrices(pcfg)
    B, Nw = xw.shape
    T = mask.shape[1]

    # extended frames (B, T, n): static-index gather, same idiom as
    # framing.frame
    idx = (np.arange(T) * hop)[:, None] + np.arange(n)[None, :]
    idx = np.minimum(idx, max(Nw - 1, 0))
    E = xw[:, idx]                                     # (B, T, n)
    A = jnp.where(jnp.arange(n) < w, E, 0.0)           # windowed part

    if Nc > n:
        pad = [(0, 0), (0, 0), (0, Nc - n)]
        E = jnp.pad(E, pad)
        A = jnp.pad(A, pad)

    cm, sm = jnp.asarray(cos_m), jnp.asarray(sin_m)
    re_a = jnp.matmul(A, cm, precision=precision)
    im_a = -jnp.matmul(A, sm, precision=precision)
    re_e = jnp.matmul(E, cm, precision=precision)
    im_e = -jnp.matmul(E, sm, precision=precision)
    # conj(FA) * FE
    R = re_a * re_e + im_a * im_e
    I = re_a * im_e - im_a * re_e
    num = (jnp.matmul(R, jnp.asarray(cl), precision=precision)
           - jnp.matmul(I, jnp.asarray(sl), precision=precision))

    # window energies: one cumsum + static slices
    cs = jnp.cumsum(E[..., :n] * E[..., :n], axis=-1)
    e0 = cs[..., w - 1]                                # (B, T)
    lo, hi = pcfg.min_lag, pcfg.max_lag
    e_lag = (cs[..., w - 1 + lo: w + hi] - cs[..., lo - 1: hi])

    if ball is None:
        mask_f = mask.astype(e0.dtype)
        n_valid = jnp.maximum(mask_f.sum(axis=1), 1.0)
        mean_e = (e0 * mask_f).sum(axis=1) / n_valid   # (B,)
        ball = pcfg.ballast * mean_e * mean_e

    prod = jnp.maximum(e0[..., None] * e_lag, 1e-30)
    denom_plain = jnp.sqrt(prod)
    denom_ball = jnp.sqrt(prod + ball[:, None, None])
    return num / denom_ball, num / denom_plain


def mean_frame_energy(xw: jnp.ndarray, pcfg: PitchConfig,
                      mask: jnp.ndarray) -> jnp.ndarray:
    """(B,) masked mean of per-frame window energies e0 (the chunked
    path's global ballast input; nccf() derives the same quantity from
    its frame tensor — equal up to f32 summation order).

    Computed from LOCAL hop-block partial sums: frame t's window covers
    hop-blocks [t, t+q) fully plus the first r samples of block t+q
    (q, r = divmod(frame_len_w, hop_len_w)), so e0 is a static sum of q
    shifted block-sum slices + one head slice.  A single global cumsum
    difference (the previous formulation) carries f32 cancellation error
    that grows with signal length (ADVICE r4); block sums keep every
    accumulation window-sized."""
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    T = mask.shape[1]
    B, Nw = xw.shape
    q, r = divmod(w, hop)
    need = (T + q) * hop   # last sample any frame's window can touch
    s2 = xw * xw
    if Nw >= need:
        s2 = s2[:, :need]
    else:   # frames past the signal read zeros (they are masked anyway)
        s2 = jnp.concatenate(
            [s2, jnp.zeros((B, need - Nw), xw.dtype)], axis=1)
    s2b = s2.reshape(B, T + q, hop)
    bs = s2b.sum(axis=-1)                        # (B, T+q) block sums
    e0 = jnp.zeros((B, T), xw.dtype)
    for k in range(q):
        e0 = e0 + bs[:, k: k + T]
    if r:
        hr = s2b[:, :, :r].sum(axis=-1)          # (B, T+q) head sums
        e0 = e0 + hr[:, q: q + T]
    mask_f = mask.astype(e0.dtype)
    n_valid = jnp.maximum(mask_f.sum(axis=1), 1.0)
    return (e0 * mask_f).sum(axis=1) / n_valid


def _nccf_chunked(xw: jnp.ndarray, pcfg: PitchConfig, mask: jnp.ndarray,
                  K: int, *, precision):
    """Chunked NCCF: fold time chunks of K frames into the batch axis —
    (B, Nw) signal -> (B*C, span) rows -> reassembled (B, T, n_lags).
    An opt-in: the construction is exact, and the extended-frame gather
    covers fewer elements chunked; its speed on the GPU is not measured.

    Frames are bit-identical to the unchunked dispatch on the valid
    region (chunk starts are hop multiples, so every frame reads the
    same samples and runs the same per-frame GEMM reductions); the
    ballast uses the GLOBAL masked mean energy broadcast per chunk
    (wrapper-side convention, equal to the unchunked XLA path up to f32
    summation order in the mean)."""
    B, Nw = xw.shape
    T = mask.shape[1]
    w, hop = pcfg.frame_len_w, pcfg.hop_len_w
    span = (K - 1) * hop + w + pcfg.max_lag
    C = -(-T // K)
    stride = K * hop
    need = (C + 1) * stride                  # base blocks + ctx coverage
    if Nw < need:
        xw_p = jnp.concatenate(
            [xw, jnp.zeros((B, need - Nw), xw.dtype)], axis=-1)
    else:
        xw_p = xw[:, :need] if Nw > need else xw
    # chunk rows via static reshape + shifted slice, no gather:
    # row c = [base block c | head of block c+1]
    base = xw_p[:, : C * stride].reshape(B, C, stride)
    ctx = xw_p[:, stride: (C + 1) * stride].reshape(
        B, C, stride)[:, :, : span - stride]
    xc = jnp.concatenate([base, ctx], axis=-1).reshape(B * C, span)
    flens = mask.sum(axis=1).astype(jnp.int32)      # (B,)
    g = jnp.asarray((np.arange(C) * K)[:, None] + np.arange(K)[None, :])
    mask_c = (g[None, :, :] < flens[:, None, None]).reshape(B * C, K)
    mean_e = mean_frame_energy(xw, pcfg, mask)
    ball = pcfg.ballast * mean_e * mean_e           # (B,) global
    ball_c = jnp.repeat(ball, C)
    nb, npl = nccf(xc, pcfg, mask_c, precision=precision, ball=ball_c)
    n_lags = nb.shape[-1]
    nb = nb.reshape(B, C * K, n_lags)[:, :T]
    npl = npl.reshape(B, C * K, n_lags)[:, :T]
    return nb, npl


def _viterbi_dispatch(nccf_b: jnp.ndarray, pcfg: PitchConfig, *,
                      viterbi_block: int | None,
                      viterbi_warm: int) -> jnp.ndarray:
    """viterbi(), or viterbi_blocked() when a block is requested."""
    if viterbi_block is not None:
        return viterbi_blocked(nccf_b, pcfg, block=viterbi_block,
                               warm=viterbi_warm)
    return viterbi(nccf_b, pcfg)


def viterbi(nccf_b: jnp.ndarray, pcfg: PitchConfig, *,
            unroll: int = 1) -> jnp.ndarray:
    """(B, T, n_lags) masked ballasted NCCF -> (B, T) int32 lag indices.

    ``unroll`` packs that many scan steps into one compiled loop body —
    bit-identical math.
    """
    return jax.vmap(
        lambda sc: _viterbi_one(sc, pcfg, unroll=unroll))(nccf_b)


def viterbi_blocked(nccf_b: jnp.ndarray, pcfg: PitchConfig, *,
                    block: int = 256, warm: int = 128,
                    unroll: int = 8) -> jnp.ndarray:
    """Blocked Viterbi: (B, T, n_lags) -> (B, T) lag indices with the T-step
    sequential chain cut to ``block + 2*warm`` steps (VERDICT r2 #9).

    Time is split into C = ceil(T/block) chunks solved IN PARALLEL (the
    chunk axis joins the batch vmap); each chunk sees ``warm`` extra
    frames of left and right context and keeps only its interior.  Why
    this is (near-)exact:

    - Path-merge property: Viterbi backpointer trees coalesce — two
      forward recursions differing only in their state costs at time
      t0 agree on the optimal state at time t >= t0 + W once every
      surviving path passes through a common ancestor inside the window.
      For this tracker merge is fast wherever frames are voiced (the
      NCCF emission concentrates mass on one lag neighborhood); ``warm``
      buys that window on both sides: the left context warms up the
      forward costs, the right context lets the chunk's local backtrace
      start far enough ahead that it has merged onto the true path by
      the time it re-enters the interior.
    - Edges are EXACT, not approximate: chunks are cut from the scores
      padded with zero-emission frames (the masked-padding convention of
      this module — see the module docstring's stationarity proof).  A
      zero-emission prefix keeps the cost vector uniformly zero, which
      is exactly the true initial condition, so chunk 0 needs no warm-up
      and loses nothing; a zero-emission suffix freezes both the argmin
      state and the backtrace, so the last chunk's tail is the true
      final condition.

    Deviation is therefore confined to interior chunk seams during long
    UNVOICED stretches (flat emissions — where the lag track is weakly
    determined and any path is near-equal cost).  tests/test_pitch.py
    measures it; callers opt in (execution strategy, not contract —
    same policy as backend/tile_t kwargs).

    When to opt in: few streams x many chunks (B * C >> B), where
    chunk parallelism replaces the missing batch dim; the crossover on
    the GPU is not measured.
    """
    B, T, n = nccf_b.shape
    if T <= block + 2 * warm:
        # short input: the exact (unblocked) solution
        return viterbi(nccf_b, pcfg, unroll=unroll)
    C = -(-T // block)
    Tpad = C * block
    S = jnp.pad(nccf_b, ((0, 0), (warm, Tpad - T + warm), (0, 0)))
    # static window gather: chunk c covers padded frames
    # [c*block, c*block + block + 2*warm)
    Lw = block + 2 * warm
    idx = (np.arange(C) * block)[:, None] + np.arange(Lw)[None, :]
    W = S[:, idx]                                      # (B, C, Lw, n)
    paths = jax.vmap(jax.vmap(
        lambda sc: _viterbi_one(sc, pcfg, unroll=unroll)))(W)
    interior = paths[:, :, warm: warm + block]         # (B, C, block)
    return interior.reshape(B, Tpad)[:, :T]


def _viterbi_one(scores: jnp.ndarray, pcfg: PitchConfig, *,
                 unroll: int) -> jnp.ndarray:
    """Single-sequence Viterbi (T, n_lags) -> (T,) — the vmap kernel
    shared by `viterbi` and `viterbi_blocked`."""
    trans = jnp.asarray(_trans_matrix(pcfg))

    def fwd(cost, s_t):
        tot = cost[:, None] + trans
        arg = jnp.argmin(tot, axis=0).astype(jnp.int32)
        return jnp.min(tot, axis=0) - s_t, arg

    cost, back = jax.lax.scan(fwd, -scores[0], scores[1:], unroll=unroll)
    last = jnp.argmin(cost).astype(jnp.int32)

    def bwd(nxt, arg_t):
        return arg_t[nxt], nxt

    first, rest = jax.lax.scan(bwd, last, back, reverse=True, unroll=unroll)
    return jnp.concatenate([first[None], rest])


def _path_neighborhood(nccf_p: jnp.ndarray, path: jnp.ndarray):
    """(..., n_lags) values at (path-1, path, path+1) via masked
    reductions (three iota-compares + three lane sums, no dynamic
    gather).  Out-of-range neighbors (path at a grid edge) contract to
    0 — callers mask those frames anyway."""
    n = nccf_p.shape[-1]
    lane = jnp.arange(n, dtype=jnp.int32)
    p = path[..., None]
    y0 = jnp.sum(jnp.where(lane == p, nccf_p, 0.0), axis=-1)
    ym = jnp.sum(jnp.where(lane == p - 1, nccf_p, 0.0), axis=-1)
    yp = jnp.sum(jnp.where(lane == p + 1, nccf_p, 0.0), axis=-1)
    return ym, y0, yp


def _parabolic_from(ym, y0, yp, path, n) -> jnp.ndarray:
    """Sub-sample lag refinement around the path (oracle._parabolic_lag
    semantics: 0 at grid edges or flat curvature, clipped to +-0.5)."""
    denom = ym - 2.0 * y0 + yp
    d = jnp.where(jnp.abs(denom) < 1e-12, 0.0,
                  0.5 * (ym - yp) / jnp.where(denom == 0, 1.0, denom))
    d = jnp.clip(d, -0.5, 0.5)
    return jnp.where((path == 0) | (path == n - 1), 0.0, d)




def pov_feature(c: jnp.ndarray) -> jnp.ndarray:
    """Kaldi's NCCF -> POV-feature nonlinearity: 2*((1.0001 - c)^0.15 - 1).
    pow via exp(0.15 * log(.)) with the accurate log (ops/xmath)."""
    from . import xmath
    base = 1.0001 - jnp.clip(c, -1.0, 1.0)
    return 2.0 * (jnp.exp(jnp.float32(0.15) * xmath.accurate_log(base)) - 1.0)


def weighted_sliding_mean(v: jnp.ndarray, wgt: jnp.ndarray,
                          window: int) -> jnp.ndarray:
    """(B, T) centered weighted sliding mean, edges shrink (oracle
    semantics); frames with zero total weight fall back to v[t].

    Gather-free: the clipped prefix-sum indexing (min(t+h+1, T) /
    max(t-h, 0)) is realized as edge-padded concat + static slice."""
    T = v.shape[-1]
    half = window // 2
    zero = jnp.zeros(v.shape[:-1] + (1,), v.dtype)
    pv = jnp.concatenate([zero, jnp.cumsum(v * wgt, axis=-1)], axis=-1)
    pw = jnp.concatenate([zero, jnp.cumsum(wgt, axis=-1)], axis=-1)

    def shifted(p):
        # hi: p[min(t + half + 1, T)] == (p ++ p[-1]*half)[t + half + 1]
        tail = jnp.repeat(p[..., -1:], half, axis=-1)
        hi = jnp.concatenate([p, tail], axis=-1)[..., half + 1: half + 1 + T]
        # lo: p[max(t - half, 0)] == (0*half ++ p)[t]  (p[0] is 0)
        head = jnp.zeros(p.shape[:-1] + (half,), p.dtype)
        lo = jnp.concatenate([head, p], axis=-1)[..., :T]
        return hi - lo

    sv = shifted(pv)
    sw = shifted(pw)
    return jnp.where(sw > 1e-12, sv / jnp.maximum(sw, 1e-12), v)


def pitch_features(x: jnp.ndarray, lengths: jnp.ndarray,
                   pcfg: PitchConfig, *,
                   precision=jax.lax.Precision.HIGHEST,
                   viterbi_block: int | None = None,
                   viterbi_warm: int = 128,
                   nccf_chunk: int | None = None,
                   backend: str = "auto"):
    """(B, N) zero-padded audio at pcfg.sample_rate + (B,) true lengths ->
    ((B, T, 3) [pov, normalized log pitch, delta log pitch], (B,) frame
    counts, (B, T) mask).  Matches oracle.pitch frame-for-frame on the
    valid region (zero padding commutes with the polyphase resampler's
    own zero-padded edges).

    viterbi_block: opt-in blocked Viterbi (see `viterbi_blocked`) —
    execution strategy, near-exact, measured in tests/test_pitch.py.
    nccf_chunk: opt-in chunked NCCF (see `_nccf_chunked`) — K frames per
    chunk folded into the batch axis; bit-identical frames.
    backend: a name from the backend registry (the pitch stages have
    one path)."""
    backend_lib.resolve(backend)
    B, N = x.shape
    T = pcfg.num_frames(N)
    if T <= 0:
        z = jnp.zeros((B, 0, pcfg.n_feats), jnp.float32)
        return z, jnp.zeros((B,), jnp.int32), jnp.zeros((B, 0), bool)
    xw = (resample(x.astype(jnp.float32), pcfg.sample_rate, pcfg.work_rate,
                   precision=precision)
          if pcfg.work_rate != pcfg.sample_rate else x.astype(jnp.float32))
    flens = pitch_frame_counts(lengths, pcfg)
    flens = jnp.minimum(flens, T)
    mask = jnp.arange(T, dtype=jnp.int32)[None, :] < flens[:, None]

    if nccf_chunk is not None and T > nccf_chunk:
        nccf_b, nccf_p = _nccf_chunked(xw, pcfg, mask, nccf_chunk,
                                       precision=precision)
    else:
        nccf_b, nccf_p = nccf(xw, pcfg, mask, precision=precision)
    nccf_b = jnp.where(mask[..., None], nccf_b, 0.0)
    path = _viterbi_dispatch(nccf_b, pcfg, viterbi_block=viterbi_block,
                             viterbi_warm=viterbi_warm)

    ym, c, yp = _path_neighborhood(nccf_p, path)
    dlag = _parabolic_from(ym, c, yp, path, nccf_p.shape[-1])
    lag = pcfg.min_lag + path.astype(jnp.float32) + dlag
    from . import xmath
    log_f0 = xmath.accurate_log(jnp.float32(pcfg.work_rate) / lag)

    pov = pov_feature(c)
    wgt = jnp.clip(c, 0.0, 1.0) ** 2 * mask.astype(c.dtype)
    norm = log_f0 - weighted_sliding_mean(log_f0, wgt, pcfg.norm_window)
    d = deltas_op.deltas(log_f0[..., None], pcfg.delta_window,
                         lengths=flens)[..., 0]

    feat = jnp.stack([pov, norm, d], axis=-1)
    return jnp.where(mask[..., None], feat, 0.0), flens, mask


def pitch_track(x: jnp.ndarray, lengths: jnp.ndarray, pcfg: PitchConfig, *,
                viterbi_block: int | None = None, viterbi_warm: int = 128,
                nccf_chunk: int | None = None, backend: str = "auto"):
    """(B, N), (B,) -> ((B, T) f0 in Hz, (B, T) plain NCCF 'voicing', mask).
    The raw track for consumers that want Hz rather than ASR features."""
    backend_lib.resolve(backend)
    B, N = x.shape
    T = pcfg.num_frames(N)
    if T <= 0:
        z = jnp.zeros((B, 0), jnp.float32)
        return z, z, jnp.zeros((B, 0), bool)
    xw = (resample(x.astype(jnp.float32), pcfg.sample_rate, pcfg.work_rate)
          if pcfg.work_rate != pcfg.sample_rate else x.astype(jnp.float32))
    flens = jnp.minimum(pitch_frame_counts(lengths, pcfg), T)
    mask = jnp.arange(T, dtype=jnp.int32)[None, :] < flens[:, None]
    if nccf_chunk is not None and T > nccf_chunk:
        nccf_b, nccf_p = _nccf_chunked(
            xw, pcfg, mask, nccf_chunk, precision=jax.lax.Precision.HIGHEST)
    else:
        nccf_b, nccf_p = nccf(xw, pcfg, mask,
                              precision=jax.lax.Precision.HIGHEST)
    nccf_b = jnp.where(mask[..., None], nccf_b, 0.0)
    path = _viterbi_dispatch(nccf_b, pcfg, viterbi_block=viterbi_block,
                             viterbi_warm=viterbi_warm)
    ym, c, yp = _path_neighborhood(nccf_p, path)
    lag = (pcfg.min_lag + path.astype(jnp.float32)
           + _parabolic_from(ym, c, yp, path, nccf_p.shape[-1]))
    f0 = jnp.float32(pcfg.work_rate) / lag
    return jnp.where(mask, f0, 0.0), jnp.where(mask, c, 0.0), mask
