"""Framing + pre-emphasis + analysis window (JAX).

This stage turns raw PCM into overlapping analysis frames — the front of the
pipeline, analogous to the reference compiler's lexer turning raw chars into
tokens (``/root/reference/src/mfcc/lex.c:76-98``), but vectorized: instead of
a sequential char loop we build a static (T, frame_len) gather index once at
trace time and let XLA lower it to an efficient strided load.

All functions are shape-static under ``jax.jit`` (signal length is a trace
constant), which is what keeps the whole pipeline recompile-free.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from .. import oracle


def build_window(cfg: FeatureConfig) -> np.ndarray:
    """Float64 analysis window (constant; folded into the DFT matrices)."""
    return oracle.window_fn(cfg.window, cfg.frame_len)


def frame_indices(n_samples: int, cfg: FeatureConfig) -> np.ndarray:
    """(T, frame_len) int32 gather indices for 'valid' framing."""
    T = cfg.num_frames(n_samples)
    starts = np.arange(T, dtype=np.int32) * cfg.hop_len
    return starts[:, None] + np.arange(cfg.frame_len, dtype=np.int32)[None, :]


# --------------------------------------------------------------------------
# Centered framing (frame_mode="center", Kaldi snip_edges=false — r5).
# Both constructions turn center mode into a reflect pad + the exact
# "valid" pipeline, so every stage/backend downstream is unchanged.
# --------------------------------------------------------------------------

def center_reflect_indices(n: int, cfg: FeatureConfig) -> np.ndarray:
    """(L,) int32 indices into an n-sample signal realizing the centered
    reflect pad: position p of the padded buffer reads original sample
    reflect(p - left_pad, n), with symmetric edge-duplicating reflection
    (closed form min(m, 2n-1-m), m = s mod 2n — the fixpoint of Kaldi's
    bounce loop, exact for any overhang).  L = (T-1)*hop + frame_len."""
    T = cfg.num_frames(n)  # center-mode count
    if T == 0:
        return np.zeros((0,), np.int32)
    s = np.arange((T - 1) * cfg.hop_len + cfg.frame_len,
                  dtype=np.int64) - cfg.center_left_pad
    m = np.mod(s, 2 * n)
    return np.minimum(m, 2 * n - 1 - m).astype(np.int32)


def center_pad_static(x: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(..., N) -> (..., L) centered reflect pad, N static (trace-time
    constant indices; exact Kaldi placement for any N)."""
    return x[..., center_reflect_indices(x.shape[-1], cfg)]


def center_pad_batch(x: jnp.ndarray, lengths: jnp.ndarray,
                     cfg: FeatureConfig):
    """Ragged batch centered reflect pad.

    (B, N) rows with per-row true ``lengths`` -> ((B, W) padded rows,
    (B,) padded "valid" lengths L_i such that valid framing of the
    padded row emits exactly the center-mode frame count T_i).

    Construction (all static-shape, per-row offsets via dynamic slices —
    no data-dependent gather):
    - left pad (position-static, every row starts at 0): the first
      left_pad samples flipped;
    - right pad (per-row at ``lengths[i]``): the last
      ceil(frame_len/2) samples flipped, placed by one vmapped
      dynamic_update_slice.  Single-bounce reflection is exact because
      the maximum overhang equals ceil(frame_len/2) and rows shorter
      than that emit 0 frames by the num_frames contract.
    """
    B, N = x.shape
    fl, hop = cfg.frame_len, cfg.hop_len
    P_l, R = cfg.center_left_pad, cfg.center_min_samples
    if N < R:
        # batch narrower than the minimum emitting length: every row has
        # 0 frames, but the tail dynamic_slice below needs R columns
        x = jnp.concatenate([x, jnp.zeros((B, R - N), x.dtype)], axis=-1)
        N = R
    T_cap = (N + hop // 2) // hop
    W = max((T_cap - 1) * hop + fl, fl, P_l + N + R)
    left = x[..., :P_l][..., ::-1]
    body = jnp.concatenate(
        [left, x, jnp.zeros((B, W - P_l - N), x.dtype)], axis=-1)
    start = jnp.maximum(lengths.astype(jnp.int32) - R, 0)
    tail = jax.vmap(
        lambda xi, s0: jax.lax.dynamic_slice(xi, (s0,), (R,)))(x, start)
    tail = tail[..., ::-1]
    padded = jax.vmap(
        lambda b, t, o: jax.lax.dynamic_update_slice(b, t, (o,)))(
            body, tail, P_l + lengths.astype(jnp.int32))
    T = jnp.where(lengths >= R,
                  (lengths.astype(jnp.int32) + hop // 2) // hop, 0)
    L = jnp.where(T > 0, (T - 1) * hop + fl, 0).astype(jnp.int32)
    return padded, L


def resolve_frame_mode(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                       cfg: FeatureConfig):
    """Batch-model entry hook: returns (x', sample_lengths', cfg') with
    cfg' in "valid" mode.  For center mode the signal is dithered FIRST
    (reflected samples carry reflected noise, matching the oracle's
    dither-then-pad order) and then reflect-padded; cfg' has dither off
    so the inner pipeline doesn't re-apply it."""
    if cfg.frame_mode == "valid":
        return x, sample_lengths, cfg
    if cfg.dither > 0.0:
        from . import dither as dither_op
        x = dither_op.apply_jax(x, cfg)
    xp, L = center_pad_batch(x, sample_lengths, cfg)
    return xp, L, cfg.replace(frame_mode="valid", dither=0.0)


def resolve_frame_mode_static(x: jnp.ndarray, cfg: FeatureConfig):
    """Single-utterance twin of resolve_frame_mode (static length)."""
    if cfg.frame_mode == "valid":
        return x, cfg
    if cfg.dither > 0.0:
        from . import dither as dither_op
        x = dither_op.apply_jax(x, cfg)
    return center_pad_static(x, cfg), cfg.replace(frame_mode="valid",
                                                  dither=0.0)


def preemphasize(x: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """Whole-signal pre-emphasis y[n] = x[n] - a*x[n-1], y[0] = (1-a)x[0].

    Identical to per-frame pre-emphasis with signal predecessors (the
    oracle's definition — equivalence pinned by
    tests/test_oracle.py::test_preemphasis_streaming_identity), which is
    what lets the blocked spectrum path skip frame materialization.
    """
    if cfg.preemph == 0.0:
        return x
    prev = jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    return x - jnp.asarray(cfg.preemph, x.dtype) * prev


def frame(x: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(n_samples,) -> (T, frame_len) pre-emphasized frames.

    Pre-emphasis predecessor comes from the *signal* (HTK x[-1] := x[0]
    convention at the start), matching oracle.frame_signal exactly, so
    chunked/streaming framing is bit-identical to batch framing.
    Center mode resolves to the reflect pad first (static length).
    """
    if cfg.frame_mode == "center":
        x = center_pad_static(x, cfg)
        cfg = cfg.replace(frame_mode="valid")
    idx = frame_indices(x.shape[-1], cfg)
    frames = x[..., idx]
    if cfg.preemph > 0.0:
        prev = x[..., np.maximum(idx - 1, 0)]
        frames = frames - jnp.asarray(cfg.preemph, x.dtype) * prev
    return frames


def frame_batch(x: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(B, n_samples) -> (B, T, frame_len); same semantics as frame()."""
    return frame(x, cfg)


def log_energy(frames: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(..., T, frame_len) -> (..., T) floored log frame energy."""
    from . import xmath
    e = jnp.sum(frames * frames, axis=-1)
    return xmath.floored_log(e.astype(jnp.float32), cfg.log_floor)
