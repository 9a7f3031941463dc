"""Mel filterbank projection (JAX).

The (n_bins, n_mels) triangular filterbank is a constant matrix built in
float64 by the oracle (single source of truth for the mel conventions —
see oracle.mel_filterbank) and applied as one GEMM.  This replaces the
scalar triangular-filter accumulation loops the baseline calls out
(BASELINE.json north star: "triangular filter sums" -> one matmul).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from .. import oracle
from .spectrum import resolve_precision
from . import xmath


@functools.lru_cache(maxsize=32)
def _mel_matrix_cached(key) -> np.ndarray:
    cfg = FeatureConfig(**dict(key))
    return oracle.mel_filterbank(cfg).T.copy()  # (n_bins, n_mels)


def mel_matrix(cfg: FeatureConfig) -> np.ndarray:
    """(n_bins, n_mels) float64 filterbank, cached per config."""
    import dataclasses
    return _mel_matrix_cached(tuple(sorted(dataclasses.asdict(cfg).items())))


def log_mel_energies(
    power: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
) -> jnp.ndarray:
    """(..., T, n_bins) power -> (..., T, n_mels) floored log mel energies.

    Uses xmath.floored_log rather than the hardware log: XLA's f32 log
    approximation errs ~1e-4 absolute, which alone would consume the
    pipeline's accuracy budget (see ops/xmath.py).
    """
    if precision is None:
        precision = resolve_precision(cfg)
    fb = jnp.asarray(mel_matrix(cfg), jnp.dtype(cfg.accum_dtype))
    e = jnp.matmul(power, fb, precision=precision)
    if cfg.dynamic_range_db is not None:
        rel = jnp.max(e, axis=-1, keepdims=True) * (
            10.0 ** (-cfg.dynamic_range_db / 10.0))
        e = jnp.maximum(e, rel)
    return xmath.floored_log(e, cfg.log_floor)


def log_mel_energies_split(
    power_lo: jnp.ndarray,
    power_hi: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
) -> jnp.ndarray:
    """Split-bin variant matching spectrum.power_spectrum_blocked_split:
    the big GEMM runs over n_bins-1 lane-exact bins and the top bin folds
    in as a rank-1 update — no concat materialization."""
    if precision is None:
        precision = resolve_precision(cfg)
    acc = jnp.dtype(cfg.accum_dtype)
    fb = jnp.asarray(mel_matrix(cfg), acc)           # (n_bins, n_mels)
    e = jnp.matmul(power_lo, fb[:-1], precision=precision)
    e = e + power_hi * fb[-1][None, :]
    if cfg.dynamic_range_db is not None:
        rel = jnp.max(e, axis=-1, keepdims=True) * (
            10.0 ** (-cfg.dynamic_range_db / 10.0))
        e = jnp.maximum(e, rel)
    return xmath.floored_log(e, cfg.log_floor)
