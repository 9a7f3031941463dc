"""Pitch model: NCCF + Viterbi tracker producing Kaldi-style 3-dim
features [pov_feature, POV-weighted-mean-normalized log pitch, delta log
pitch], plus a raw Hz track for non-ASR consumers.

Composition mirrors the flagship MFCC model (models/mfcc.py): batched,
static shapes, padded frames computed-then-masked.  Stage math lives in
ops/pitch.py; the float64 trust root is oracle.pitch.  Pitch frames use
"valid" framing at the work rate over the frame+max_lag NCCF span, so a
pitch track has ~2 fewer frames than the 25/10 ms MFCC track of the same
signal; :func:`align_pitch` (below; used by runner --pitch) aligns them
by edge replication.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import PitchConfig
from ..ops import pitch as pitch_op


def pitch(x: jnp.ndarray, pcfg: PitchConfig,
          backend: str = "auto") -> jnp.ndarray:
    """(n_samples,) PCM in [-1, 1] -> (T, 3) pitch features."""
    feat, _, _ = pitch_op.pitch_features(
        x[None, :], jnp.asarray([x.shape[0]], jnp.int32), pcfg,
        backend=backend)
    return feat[0]


def pitch_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                pcfg: PitchConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, 3), (B,) frame counts, (B, T) mask).

    x may be int16 PCM (cast on device) or float in [-1, 1]; zero padding
    is required past each utterance's true length (it commutes with the
    resampler's own zero-padded edge convention, so padded batches match
    oracle.pitch exactly on the valid region).
    """
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    return pitch_op.pitch_features(x, sample_lengths, pcfg,
                                   backend=backend)


def pitch_track_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                      pcfg: PitchConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T) f0 Hz, (B, T) NCCF voicing, mask)."""
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    return pitch_op.pitch_track(x, sample_lengths, pcfg, backend=backend)


def align_pitch(feat_p: jnp.ndarray, flens_p: jnp.ndarray, T: int):
    """(B, Tp, F) pitch features + (B,) true pitch frame counts ->
    (B, T, F) aligned to a T-frame main feature track.

    Both tracks share the hop (frame t starts at t * hop_ms), but pitch
    "valid" framing spans frame+max_lag work samples, so a pitch track
    runs ~2 frames short; missing tail frames are edge-replicated
    (Kaldi's paste-feats length-tolerance convention).  Utterances with
    zero pitch frames get zeros.
    """
    B, Tp, F = feat_p.shape
    if Tp == 0:
        return jnp.zeros((B, T, F), feat_p.dtype)
    # Gather-free (same rationale as ops/deltas.py): out[t] =
    # feat_p[min(t, last)] = static prefix + one last-valid-frame pick.
    t = jnp.arange(T, dtype=jnp.int32)
    last = jnp.maximum(flens_p - 1, 0).astype(jnp.int32)        # (B,)
    onehot = (jnp.arange(Tp, dtype=jnp.int32)[None, :]
              == last[:, None]).astype(feat_p.dtype)
    lastf = jnp.einsum("bt,btf->bf", onehot, feat_p,
                       precision=jax.lax.Precision.HIGHEST)[:, None, :]
    base = (feat_p[:, :T] if T <= Tp else jnp.concatenate(
        [feat_p, jnp.repeat(feat_p[:, -1:], T - Tp, axis=1)], axis=1))
    out = jnp.where(t[None, :, None] > last[:, None, None], lastf, base)
    return jnp.where(flens_p[:, None, None] > 0, out, 0.0)


@partial(jax.jit, static_argnames=("pcfg", "backend"))
def pitch_jit(x: jnp.ndarray, pcfg: PitchConfig,
              backend: str = "auto") -> jnp.ndarray:
    return pitch(x, pcfg, backend)


@partial(jax.jit, static_argnames=("pcfg", "backend"))
def pitch_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                    pcfg: PitchConfig, backend: str = "auto"):
    return pitch_batch(x, sample_lengths, pcfg, backend)


@partial(jax.jit, static_argnames=("pcfg", "backend"))
def pitch_track_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                          pcfg: PitchConfig, backend: str = "auto"):
    return pitch_track_batch(x, sample_lengths, pcfg, backend)
