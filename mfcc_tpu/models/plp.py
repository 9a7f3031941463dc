"""PLP pipeline (Hermansky 1990) — the third classic speech front-end.

Shares the framing/window/GEMM-DFT front half with the MFCC pipeline,
then replaces mel/log/DCT with critical-band (bark) analysis, equal
loudness, cube-root compression, and an all-pole (LPC) cepstral model —
see ops/plp.py for the GEMM mapping and docs/conventions.md for the exact
conventions.  The float64 trust root is oracle.plp.

The spectral front half — framing, window-folded DFT, bark+equal-loudness
band energies — shares the MFCC pipeline's hop-block GEMM path; the back
half (cube-root loudness, autocorrelation IDFT, Levinson, cepstral
recursion) operates on the small (B, T, n_bark) tensor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import backend as backend_lib
from ..config import FeatureConfig
from ..ops import framing, spectrum, deltas as deltas_op
from ..ops import plp as plp_op
from .mfcc import frame_lengths, frame_mask  # noqa: F401 (re-export)


def _plp_from_audio(x: jnp.ndarray, cfg: FeatureConfig,
                    lengths: jnp.ndarray | None = None,
                    backend: str = "auto") -> jnp.ndarray:
    backend_lib.resolve(backend, cfg)          # rejects unknown names
    if cfg.dither > 0.0:
        from ..ops import dither as dither_op
        with jax.named_scope("dither"):
            x = dither_op.apply_jax(x, cfg)
    with jax.named_scope("preemph"):
        y = framing.preemphasize(x, cfg)
    with jax.named_scope("stft_power"):
        p_lo, p_hi = spectrum.power_spectrum_split(y, cfg)
    with jax.named_scope("plp"):
        feat = plp_op.plp_from_power_split(p_lo, p_hi, cfg)
    if cfg.append_energy:
        e = spectrum.log_energy_blocked(y, cfg)
        feat = feat.at[..., 0].set(e)
    if cfg.deltas:
        with jax.named_scope("deltas"):
            feat = deltas_op.append_deltas(feat, cfg, lengths)
    return feat


def plp(x: jnp.ndarray, cfg: FeatureConfig,
        backend: str = "auto") -> jnp.ndarray:
    """(n_samples,) PCM in [-1, 1] -> (T, n_feats) PLP cepstra."""
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _plp_from_audio(x, cfg, backend=backend)


def plp_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
              cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_feats), (B,), (B, T))."""
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    x, sample_lengths, cfg = framing.resolve_frame_mode(
        x, sample_lengths, cfg)
    flens = frame_lengths(sample_lengths, cfg)
    feat = _plp_from_audio(x, cfg, lengths=flens if cfg.deltas else None,
                           backend=backend)
    mask = frame_mask(feat.shape[-2], flens)
    feat = jnp.where(mask[..., None], feat, 0.0)
    return feat, flens, mask


@partial(jax.jit, static_argnames=("cfg", "backend"))
def plp_jit(x: jnp.ndarray, cfg: FeatureConfig,
            backend: str = "auto") -> jnp.ndarray:
    return plp(x, cfg, backend)


@partial(jax.jit, static_argnames=("cfg", "backend"))
def plp_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                  cfg: FeatureConfig, backend: str = "auto"):
    return plp_batch(x, sample_lengths, cfg, backend)
