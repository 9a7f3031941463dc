"""Feature post-processing: sliding-window CMVN, context splicing,
energy VAD.

The Kaldi post-processing trio (apply-cmvn-sliding, splice-feats,
compute-vad) that sits between a front-end and an acoustic model.  All
three are windowed reductions over the time axis, implemented with the
same two gather-free idioms the rest of the framework uses: one
cumulative sum + static slices for sliding statistics, and a static
clipped-index gather for context windows.  Everything is (B, T, F)
batched, padding-aware via the frame-count vector, and shape-static
under jit.  Float64 twins live in oracle.py; parity in
tests/test_post.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _window_sums(v: jnp.ndarray, window: int):
    """(B, T, ...) -> per-frame sums over the centered window (edges
    shrink) and the per-frame effective window counts (B, T)."""
    T = v.shape[1]
    half = window // 2
    zero = jnp.zeros_like(v[:, :1])
    cs = jnp.concatenate([zero, jnp.cumsum(v, axis=1)], axis=1)
    hi = np.minimum(np.arange(T) + half + 1, T)      # static indices
    lo = np.maximum(np.arange(T) - half, 0)
    return cs[:, hi] - cs[:, lo], (hi - lo)


def sliding_cmvn(feat: jnp.ndarray, flens: jnp.ndarray, window: int = 600,
                 normalize_variance: bool = False) -> jnp.ndarray:
    """(B, T, F) + (B,) frame counts -> per-frame sliding mean (and
    optionally variance) normalization over a centered `window`.

    Conventions (documented in docs/conventions.md): the window is
    centered and SHRINKS at utterance edges (never slides past frame 0
    or length-1 — for T <= window this equals per-utterance CMVN);
    padded frames are excluded from every window (they stay zero on
    output).  Variance is floored at 1e-8 before the rsqrt.
    """
    T = feat.shape[1]
    mask = (jnp.arange(T, dtype=jnp.int32)[None, :]
            < flens[:, None]).astype(feat.dtype)
    half = window // 2
    # per-utterance clamp of the static window bounds: [lo, hi) must stay
    # inside [0, flen) per row, so count = min(hi, flen) - min(lo, flen)
    t = np.arange(T)
    hi_s = np.minimum(t + half + 1, T)[None, :]      # static part
    lo_s = np.maximum(t - half, 0)[None, :]
    fl = flens[:, None]
    cnt = (jnp.minimum(hi_s, fl) - jnp.minimum(lo_s, fl)).astype(feat.dtype)
    cnt = jnp.maximum(cnt, 1.0)

    # Cancellation-resistant one-pass stats: all window sums run on data
    # shifted by the utterance's first frame c.  var and (feat - mean) are
    # shift-invariant in exact arithmetic; in f32 the shift keeps
    # E[x'^2] ~ var instead of var + mean^2, whose difference cancels
    # catastrophically for short windows when |mean| ~ std.
    c = feat[:, :1, :]
    fs = (feat - c) * mask[..., None]
    sums, _ = _window_sums(fs, window)               # masked, shifted sums
    mean_s = sums / cnt[..., None]
    out = (feat - c) - mean_s
    if normalize_variance:
        sq, _ = _window_sums(fs * fs, window)
        var = jnp.maximum(sq / cnt[..., None] - mean_s * mean_s, 1e-8)
        out = out / jnp.sqrt(var)
    return out * mask[..., None]


def online_cmvn(feat: jnp.ndarray, flens: jnp.ndarray, window: int = 600,
                normalize_variance: bool = False,
                prior=None) -> jnp.ndarray:
    """(B, T, F) + (B,) frame counts -> CAUSAL online CMVN.

    Frame t is normalized by the stats of frames
    [max(0, t - window + 1), t] — trailing window including the current
    frame, zero lookahead (Kaldi apply-cmvn-online semantics; the
    batch-mode twin of models/streaming.online_cmvn_step, and the float64
    contract is oracle.online_cmvn).  ``prior``: optional
    (count (), sum (F,), sumsq (F,)) global stats blended with weight
    min(prior_count, window - cnt) while the window is young.  Padded
    frames never enter any window and stay zero on output.
    """
    B, T, F = feat.shape
    mask = (jnp.arange(T, dtype=jnp.int32)[None, :]
            < flens[:, None]).astype(feat.dtype)
    # Shifted one-pass stats (see sliding_cmvn): offset = frame 0, which is
    # CAUSAL (always the first frame any window sees) so past outputs stay
    # bit-identical when future frames change.
    c = feat[:, :1, :]
    fs = (feat - c) * mask[..., None]
    zero = jnp.zeros_like(fs[:, :1])
    cs = jnp.concatenate([zero, jnp.cumsum(fs, axis=1)], axis=1)
    t = np.arange(T)
    lo_s = np.maximum(t - window + 1, 0)[None, :]
    hi_s = (t + 1)[None, :]
    sums = cs[:, hi_s[0]] - cs[:, lo_s[0]]
    fl = flens[:, None]
    cnt = (jnp.minimum(hi_s, fl) - jnp.minimum(lo_s, fl)).astype(feat.dtype)
    cnt = jnp.maximum(cnt, 1.0)
    if normalize_variance:
        cs2 = jnp.concatenate([zero, jnp.cumsum(fs * fs, axis=1)], axis=1)
        sq = cs2[:, hi_s[0]] - cs2[:, lo_s[0]]
    else:
        sq = None
    cnt, sums, sq = _blend_prior(cnt, sums, sq, window, prior, offset=c)
    mean_s = sums / cnt[..., None]
    out = (feat - c) - mean_s
    if normalize_variance:
        var = jnp.maximum(sq / cnt[..., None] - mean_s * mean_s, 1e-8)
        out = out / jnp.sqrt(var)
    return out * mask[..., None]


def _blend_prior(cnt, sums, sq, window, prior, offset=None):
    """Add min(prior_count, window - cnt) worth of the prior stats.

    ``offset``: when the window sums were computed on offset-shifted data
    x' = x - c (the cancellation-resistant formulation), the prior's raw
    (count, sum, sumsq) must be expressed in the same shifted frame:
    sum' = sum - count*c, sumsq' = sumsq - 2c*sum + count*c^2.  When the
    window is already full (w == 0) all added terms are exact zeros, so
    the with-prior and no-prior paths stay bit-identical there.
    """
    if prior is None:
        return cnt, sums, sq
    pc, ps, pss = prior
    pc = jnp.asarray(pc, cnt.dtype)
    ps = jnp.asarray(ps)
    pss = jnp.asarray(pss)
    if offset is not None:
        c = offset
        pss = pss - 2.0 * c * ps + pc * c * c
        ps = ps - pc * c
    w = jnp.clip(jnp.asarray(window, cnt.dtype) - cnt, 0.0, pc)
    scale = jnp.where(pc > 0.0, w / jnp.maximum(pc, 1e-30), 0.0)
    cnt = cnt + w
    sums = sums + scale[..., None] * ps      # (F,) / (B,1,F) broadcasts
    if sq is not None:
        sq = sq + scale[..., None] * pss
    return cnt, sums, sq


def splice(feat: jnp.ndarray, flens: jnp.ndarray, left: int = 3,
           right: int = 3) -> jnp.ndarray:
    """(B, T, F) -> (B, T, (left+1+right)*F) context splicing.

    Frame t's output is [x[t-left], ..., x[t], ..., x[t+right]] with
    neighbor indices clipped to [0, flen-1] per utterance (edge
    replication at the true ragged boundary — same convention as the
    delta stage).  Padded frames stay zero.

    Gather-free (same rationale as ops/deltas.py): static shifts via
    edge-padded concat + slice; the ragged end-edge is one per-utterance
    last-valid-frame pick, not a (B, T, F) take_along_axis per column.
    """
    B, T, F = feat.shape
    t = jnp.arange(T, dtype=jnp.int32)
    hi_cap = jnp.maximum(flens, 1).astype(jnp.int32) - 1        # (B,)
    onehot = (t[None, :] == hi_cap[:, None]).astype(feat.dtype)
    last = jnp.einsum("bt,btf->bf", onehot, feat,               # (B,1,F)
                      precision=jax.lax.Precision.HIGHEST)[:, None, :]
    cols = []
    for off in range(-left, right + 1):
        if off < 0:
            col = jnp.concatenate(
                [jnp.repeat(feat[:, :1], -off, axis=1), feat[:, :off]],
                axis=1)
        elif off == 0:
            col = feat
        else:
            col = jnp.concatenate(
                [feat[:, off:], jnp.repeat(feat[:, -1:], off, axis=1)],
                axis=1)
            edge = (t[None, :, None] + off) > hi_cap[:, None, None]
            col = jnp.where(edge, last, col)
        cols.append(col)
    out = jnp.concatenate(cols, axis=-1)
    mask = t[None, :] < flens[:, None]
    return jnp.where(mask[..., None], out, 0.0)


def energy_vad(log_energy: jnp.ndarray, flens: jnp.ndarray,
               threshold: float = 0.0, mean_scale: float = 0.5,
               context: int = 0, proportion: float = 0.6) -> jnp.ndarray:
    """(B, T) per-frame log energy + (B,) counts -> (B, T) bool voiced.

    Kaldi compute-vad semantics: a frame's raw decision is
    log_e > threshold + mean_scale * mean(log_e over the utterance);
    NOTE Kaldi's threshold default (5.0) assumes int16-scaled waveforms
    whose log energies sit ~20.8 higher than this framework's [-1, 1]
    floats — threshold 0.0 is the equivalent operating point here;
    with context > 0 the final decision takes the vote of the
    +-context window — voiced iff >= proportion of its (in-utterance)
    frames pass the raw test.  Padded frames are always unvoiced and
    never vote.
    """
    T = log_energy.shape[1]
    mask = jnp.arange(T, dtype=jnp.int32)[None, :] < flens[:, None]
    mf = mask.astype(log_energy.dtype)
    n = jnp.maximum(mf.sum(axis=1), 1.0)
    mean_e = (log_energy * mf).sum(axis=1) / n
    thr = threshold + mean_scale * mean_e
    raw = (log_energy > thr[:, None]) & mask
    if context <= 0:
        return raw
    votes, _ = _window_sums(raw.astype(jnp.float32)[..., None],
                            2 * context + 1)
    in_win, _ = _window_sums(mf[..., None], 2 * context + 1)
    frac = votes[..., 0] / jnp.maximum(in_win[..., 0], 1.0)
    return (frac >= proportion) & mask
