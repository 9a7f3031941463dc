"""Log-power spectrogram features (no mel, no DCT).

The third member of the feature family (MFCC / log-mel / spectrogram):
(T, n_bins) floored log power spectra, same framing/window/DFT contract
as the rest of the pipeline.  Useful for neural front-ends that learn
their own filterbanks downstream.

Accuracy: the family's contract is 2e-4 inside a 50 dB window (a raw
single-bin log is f32-summation-limited: real speech drives the path to
1.7e-4, golden-pinned in tests/test_golden.py); below the window the
valleys are f32-floor-limited (docs/conventions.md accuracy policy).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import backend as backend_lib
from ..config import FeatureConfig
from ..ops import framing, spectrum, xmath
from .mfcc import frame_lengths, frame_mask


def log_spectrogram(x: jnp.ndarray, cfg: FeatureConfig,
                    backend: str = "auto") -> jnp.ndarray:
    """(n_samples,) -> (T, n_bins) floored log power spectrum."""
    backend_lib.resolve(backend, cfg)          # rejects unknown names
    if x.ndim == 1:  # batch callers resolve the frame mode themselves
        x, cfg = framing.resolve_frame_mode_static(x, cfg)
    y = framing.preemphasize(x, cfg)
    p_lo, p_hi = spectrum.power_spectrum_split(y, cfg)
    power = jnp.concatenate([p_lo, p_hi], axis=-1)
    return xmath.floored_log(power, cfg.log_floor)


def log_spectrogram_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                          cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_bins), (B,), (B, T))."""
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    x, sample_lengths, cfg = framing.resolve_frame_mode(
        x, sample_lengths, cfg)
    feat = log_spectrogram(x, cfg, backend)
    flens = frame_lengths(sample_lengths, cfg)
    mask = frame_mask(feat.shape[-2], flens)
    feat = jnp.where(mask[..., None], feat, 0.0)
    return feat, flens, mask


@partial(jax.jit, static_argnames=("cfg", "backend"))
def log_spectrogram_jit(x: jnp.ndarray, cfg: FeatureConfig,
                        backend: str = "auto") -> jnp.ndarray:
    return log_spectrogram(x, cfg, backend)


@partial(jax.jit, static_argnames=("cfg", "backend"))
def log_spectrogram_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                              cfg: FeatureConfig, backend: str = "auto"):
    return log_spectrogram_batch(x, sample_lengths, cfg, backend)
