"""Log-mel filterbank variant (DCT skipped) — baseline config 3.

Identical front half to the MFCC pipeline; stops at floored log mel
energies and optionally appends delta / delta-delta.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from ..ops import framing
from .mfcc import (frame_lengths, frame_mask,  # noqa: F401 (re-export)
                   _features_from_audio)


def log_mel(x: jnp.ndarray, cfg: FeatureConfig,
            backend: str = "auto") -> jnp.ndarray:
    """(n_samples,) -> (T, n_mels[*3]) log-mel features."""
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _features_from_audio(x, cfg, backend=backend, apply_dct=False)


def log_mel_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                  cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_mels[*3]), (B,), (B, T))."""
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    x, sample_lengths, cfg = framing.resolve_frame_mode(
        x, sample_lengths, cfg)
    flens = frame_lengths(sample_lengths, cfg)
    feat = _features_from_audio(x, cfg,
                                lengths=flens if cfg.deltas else None,
                                backend=backend, apply_dct=False)
    mask = frame_mask(feat.shape[-2], flens)
    feat = jnp.where(mask[..., None], feat, 0.0)
    return feat, flens, mask


@partial(jax.jit, static_argnames=("cfg", "backend"))
def log_mel_jit(x: jnp.ndarray, cfg: FeatureConfig,
                backend: str = "auto") -> jnp.ndarray:
    return log_mel(x, cfg, backend)


@partial(jax.jit, static_argnames=("cfg", "backend"))
def log_mel_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                      cfg: FeatureConfig, backend: str = "auto"):
    return log_mel_batch(x, sample_lengths, cfg, backend)
