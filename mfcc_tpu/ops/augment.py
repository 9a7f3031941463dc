"""Training-time augmentation: SpecAugment masking + speed perturbation.

The trainable front-end (models/trainable.py) exists to feed NN training;
production speech training feeds SpecAugment-ed features (Park et al.,
2019, "SpecAugment: A Simple Data Augmentation Method for ASR").  This is
a device-friendly implementation: every mask is a branch-free iota
comparison under ONE jit — no dynamic shapes, no host round-trips, no
boolean indexing — so it fuses into whatever consumer follows.

Scope: frequency masking + time masking (the components the paper's
ablations show carry the effect).  Time *warping* is intentionally not
implemented: it needs sparse image interpolation, contributes the least
in the paper's own ablation (Table 3), and would be the one op here that
fights the hardware.

This is a training-time op, NOT part of the feature-extraction numerical
contract: there is no float64 oracle twin, determinism is per
``jax.random.PRNGKey`` (the standard JAX training idiom, unlike the
dither op whose counter-based noise must be reproducible sample-for-
sample across oracle and pipeline).

Ragged batches: pass ``num_frames`` so time masks land inside the valid
region and padding frames stay exactly zero (CMVN-style masked consumers
rely on that).
"""

from __future__ import annotations

import functools
from typing import Union

import jax
import jax.numpy as jnp


def speed_perturb(x: jnp.ndarray, lengths: jnp.ndarray, factor: float,
                  sample_rate: int = 16_000, *,
                  precision=jax.lax.Precision.HIGHEST):
    """Kaldi-style speed perturbation (the classic 0.9/1.0/1.1 training
    augmentation): time-scale the waveform by ``factor`` via the
    polyphase resampler (ops/resample — playing at sample_rate while
    resampled BY 1/factor is a time stretch; the Kaiser anti-alias
    filter handles the 1.1x bandwidth reduction).

    x: (..., N) padded audio; lengths: (...,) true sample counts.
    Returns (x' (..., N'), lengths'): N' = resampled_length(N, .) —
    static, so each factor is one compiled program (the standard 3-way
    perturb costs 3 programs per bucket, same discipline as the bucket
    ladder).  A training-time op like SpecAugment: no oracle twin; the
    resampler itself is float64-twinned (tests/test_resample.py).
    """
    from .resample import resample, reduce_ratio
    if factor == 1.0:
        return x, lengths
    # emit at rate sr/factor, play at sr: duration scales by 1/factor
    sr_out = int(round(sample_rate / factor))
    y = resample(x, sample_rate, sr_out, precision=precision)
    L, M = reduce_ratio(sample_rate, sr_out)
    new_len = (lengths.astype(jnp.int32) * L + (M - 1)) // M
    return y, jnp.minimum(new_len, y.shape[-1]).astype(jnp.int32)


def _uniform_int(key, maxval):
    """Uniform int32 in [0, maxval] (inclusive); maxval may be traced."""
    u = jax.random.uniform(key, ())
    return jnp.floor(u * (maxval.astype(jnp.float32) + 1.0)).astype(jnp.int32)


def _masks_1d(key, length: int, n_masks: int, max_width: int, limit):
    """(length,) bool: union of ``n_masks`` random [start, start+width)
    intervals, width <= max_width, fully inside [0, limit)."""
    pos = jnp.arange(length, dtype=jnp.int32)
    masked = jnp.zeros((length,), bool)
    for k in jax.random.split(key, n_masks):
        kw, ks = jax.random.split(k)
        width = _uniform_int(kw, jnp.minimum(max_width, limit))
        start = _uniform_int(ks, jnp.maximum(limit - width, 0))
        masked |= (pos >= start) & (pos < start + width)
    return masked


def spec_augment(
    feat: jnp.ndarray,
    key: jax.Array,
    *,
    n_freq_masks: int = 2,
    freq_mask_width: int = 15,
    n_time_masks: int = 2,
    time_mask_width: int = 70,
    time_mask_frac: float = 1.0,
    num_frames: jnp.ndarray | None = None,
    mask_value: Union[float, str] = 0.0,
) -> jnp.ndarray:
    """(..., T, F) features -> same shape with random T/F stripes masked.

    - ``n_freq_masks`` stripes of width U[0, freq_mask_width] on the
      feature axis; ``n_time_masks`` of width U[0, min(time_mask_width,
      time_mask_frac * valid_frames)] on the time axis (the paper's
      adaptive p-cap).
    - ``num_frames``: per-utterance valid frame counts for ragged
      batches; time masks are then drawn inside the valid region only.
    - ``mask_value``: fill value; ``"mean"`` uses the per-utterance mean
      over valid frames (the paper's convention for log-mel).
    - Batched inputs split the key per utterance (independent masks).

    Defaults are the paper's LibriSpeech "LD" policy scaled to this
    framework's 10 ms hop.  Gradients flow through unmasked positions
    only — safe inside a trainable front-end loss.
    """
    if feat.ndim > 2:
        keys = jax.random.split(key, feat.shape[0])
        fn = functools.partial(
            spec_augment, n_freq_masks=n_freq_masks,
            freq_mask_width=freq_mask_width, n_time_masks=n_time_masks,
            time_mask_width=time_mask_width, time_mask_frac=time_mask_frac,
            mask_value=mask_value)
        if num_frames is None:
            return jax.vmap(lambda f, k: fn(f, k))(feat, keys)
        return jax.vmap(lambda f, k, n: fn(f, k, num_frames=n))(
            feat, keys, num_frames)

    T, F = feat.shape
    kf, kt = jax.random.split(key)
    valid = (jnp.asarray(T, jnp.int32) if num_frames is None
             else num_frames.astype(jnp.int32))
    t_cap = jnp.minimum(
        time_mask_width,
        jnp.floor(time_mask_frac * valid.astype(jnp.float32)).astype(
            jnp.int32))
    fmask = _masks_1d(kf, F, n_freq_masks, freq_mask_width,
                      jnp.asarray(F, jnp.int32))
    tmask = _masks_1d(kt, T, n_time_masks, t_cap, valid)
    hit = tmask[:, None] | fmask[None, :]
    if mask_value == "mean":
        tpos = jnp.arange(T, dtype=jnp.int32)
        in_valid = (tpos < valid)[:, None]
        denom = jnp.maximum(valid.astype(feat.dtype) * F, 1.0)
        fill = jnp.sum(jnp.where(in_valid, feat, 0.0)) / denom
    else:
        fill = jnp.asarray(mask_value, feat.dtype)
    out = jnp.where(hit, fill, feat)
    if num_frames is not None:  # padding frames stay exactly zero
        tpos = jnp.arange(T, dtype=jnp.int32)
        out = jnp.where((tpos < valid)[:, None], out, 0.0)
    return out


spec_augment_jit = jax.jit(
    spec_augment,
    static_argnames=("n_freq_masks", "freq_mask_width", "n_time_masks",
                     "time_mask_width", "time_mask_frac", "mask_value"))
