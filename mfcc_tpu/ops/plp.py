"""PLP compute stages (Hermansky 1990).

Everything spectral is a GEMM against constant-folded float64-built
matrices (same discipline as the mel/DCT stages): critical-band energies
with the equal-loudness curve folded into the bark filterbank, and the
autocorrelation as an IDFT matrix product.  The two short recursions
(Levinson-Durbin and LPC->cepstra) unroll to ``lpc_order`` / ``n_mfcc``
steps of fully-batched (B, T)-wide elementwise ops — static trip counts,
no scan state, trivial next to the DFT GEMMs.

Numerical notes:
- cube-root compression uses exp(0.33 * accurate_log(x)): XLA's f32 pow
  lowers through its ~1e-4-abs-error log (ops/xmath.py), which alone
  would eat the feature tolerance.
- Levinson-Durbin in f32 vs the float64 oracle was measured at ~1e-6
  max cepstral error over random smooth spectra before this module was
  built — the recursion is benign for loudness-compressed band spectra
  (tests/test_plp.py pins the end-to-end bound).

Matrix builders live in oracle.py (the float64 trust root), as for every
other stage.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..config import FeatureConfig
from .. import oracle
from .spectrum import resolve_precision
from . import xmath


@functools.lru_cache(maxsize=32)
def _matrices_cached(key):
    (sample_rate, n_fft, fmin, fmax, n_bark, order) = key
    cfg = FeatureConfig(sample_rate=sample_rate, n_fft=n_fft, fmin=fmin,
                        fmax=fmax, n_bark=n_bark, lpc_order=order)
    fb = oracle.bark_filterbank(cfg)                    # (n_bark, n_bins)
    A = oracle.autocorr_idft_matrix(n_bark + 2, order)  # (n_bark+2, p+1)
    # fold the edge-band duplication into the IDFT matrix: phi = [b0, b,
    # b_last] => r = b @ A2 with A2 = A[1:-1] (+ A[0] into column 0, A[-1]
    # into column -1 of the bark rows)
    A2 = A[1:-1].copy()
    A2[0] += A[0]
    A2[-1] += A[-1]
    return fb, A2


def _plp_matrices(cfg: FeatureConfig):
    return _matrices_cached((cfg.sample_rate, cfg.n_fft, cfg.fmin, cfg.fmax,
                             cfg.n_bark, cfg.lpc_order))


def bark_loudness_split(power_lo, power_hi, cfg: FeatureConfig, *,
                        precision=None):
    """Split-bin power spectrum -> (..., T, n_bark) cube-root loudness."""
    if precision is None:
        precision = resolve_precision(cfg)
    acc = jnp.dtype(cfg.accum_dtype)
    fb, _ = _plp_matrices(cfg)
    fbj = jnp.asarray(fb.T, acc)                        # (n_bins, n_bark)
    e = jnp.matmul(power_lo, fbj[:-1], precision=precision)
    e = e + power_hi * fbj[-1][None, :]
    return jnp.exp(jnp.float32(0.33)
                   * xmath.floored_log(e, cfg.log_floor))


def autocorrelation(loudness, cfg: FeatureConfig, *, precision=None):
    """(..., T, n_bark) loudness -> (..., T, lpc_order+1) autocorrelation
    (edge-band duplication folded into the IDFT matrix)."""
    if precision is None:
        precision = resolve_precision(cfg)
    _, A2 = _plp_matrices(cfg)
    return jnp.matmul(loudness, jnp.asarray(A2, jnp.float32),
                      precision=precision)


def levinson(r, order: int):
    """Batched Levinson-Durbin: (..., order+1) autocorrelation ->
    (a (..., order+1), residual energy e (...,)).  Unrolled (static
    order); every step is elementwise over the leading batch/time dims."""
    e = jnp.maximum(r[..., 0], 1e-20)
    a = jnp.zeros_like(r).at[..., 0].set(1.0)
    for i in range(1, order + 1):
        acc = jnp.sum(a[..., :i] * r[..., 1: i + 1][..., ::-1], axis=-1)
        k = -acc / e
        upd = a[..., 1: i + 1] + k[..., None] * a[..., i - 1:: -1]
        a = a.at[..., 1: i + 1].set(upd)
        e = jnp.maximum(e * (1.0 - k * k), 1e-20)
    return a, e


def lpc_to_cepstra(a, e, n_ceps: int):
    """(..., p+1) LPC + (...,) gain -> (..., n_ceps) model cepstra;
    c0 = log residual energy (accurate log, same as every other stage)."""
    p = a.shape[-1] - 1
    cols = [xmath.accurate_log(e)]
    for m in range(1, n_ceps):
        s = -a[..., m] if m <= p else jnp.zeros_like(e)
        for k in range(1, m):
            if m - k <= p:
                s = s - (k / m) * cols[k] * a[..., m - k]
        cols.append(s)
    return jnp.stack(cols, axis=-1)


def plp_from_power_split(power_lo, power_hi, cfg: FeatureConfig, *,
                         precision=None):
    """Split-bin power spectrum -> (..., T, n_mfcc) PLP cepstra
    (liftered; energy/deltas handled by the model layer)."""
    loud = bark_loudness_split(power_lo, power_hi, cfg, precision=precision)
    return _plp_from_loudness(loud, cfg, precision=precision)


def _plp_from_loudness(loud, cfg: FeatureConfig, *, precision=None):
    r = autocorrelation(loud, cfg, precision=precision)
    a, e = levinson(r, cfg.lpc_order)
    c = lpc_to_cepstra(a, e, cfg.n_mfcc)
    lift = oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    if cfg.lifter > 0:
        c = c * jnp.asarray(lift, jnp.float32)[None, :]
    return c
