"""The flagship MFCC pipeline.

Composes the ops stages frame -> power -> log-mel -> DCT under a single
``jax.jit`` so XLA fuses the elementwise stages into the GEMMs, with
strict inter-stage data contracts, data-parallel over frames and
utterances.

Two entry points:

- :func:`mfcc` — one utterance, shape-static.
- :func:`mfcc_batch` — padded ragged batch + per-utterance sample lengths;
  returns features, true frame counts, and a frame validity mask.  Padded
  frames are computed-then-masked (branch-free) and
  zeroed so downstream masked reductions (CMVN) are exact.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from ..ops import framing, spectrum, mel, dct, deltas as deltas_op
from .. import backend as backend_lib


def _features(frames: jnp.ndarray, cfg: FeatureConfig,
              lengths: jnp.ndarray | None = None) -> jnp.ndarray:
    """Frames-based core (streaming path): (..., T, frame_len) -> features."""
    power = spectrum.power_spectrum(frames, cfg)
    logmel = mel.log_mel_energies(power, cfg)
    feat = dct.cepstra(logmel, cfg)
    if cfg.append_energy:
        e = framing.log_energy(frames, cfg)
        feat = feat.at[..., 0].set(e)
    if cfg.deltas:
        feat = deltas_op.append_deltas(feat, cfg, lengths)
    return feat


def _features_from_audio(x: jnp.ndarray, cfg: FeatureConfig,
                         lengths: jnp.ndarray | None = None,
                         backend: str = "auto",
                         apply_dct: bool = True) -> jnp.ndarray:
    """Audio-based core (batch path): hop-block GEMM decomposition, no
    frame materialization (spectrum.power_spectrum_blocked)."""
    if cfg.dither > 0.0:
        from ..ops import dither as dither_op
        with jax.named_scope("dither"):
            x = dither_op.apply_jax(x, cfg)
    backend_lib.resolve(backend, cfg)          # rejects unknown names
    with jax.named_scope("preemph"):
        y = framing.preemphasize(x, cfg)
    with jax.named_scope("stft_power"):
        p_lo, p_hi = spectrum.power_spectrum_split(y, cfg)
    with jax.named_scope("mel_log"):
        logmel = mel.log_mel_energies_split(p_lo, p_hi, cfg)
    with jax.named_scope("dct"):
        feat = dct.cepstra(logmel, cfg) if apply_dct else logmel
    if cfg.append_energy and apply_dct:
        e = spectrum.log_energy_blocked(y, cfg)
        feat = feat.at[..., 0].set(e)
    if cfg.deltas:
        with jax.named_scope("deltas"):
            feat = deltas_op.append_deltas(feat, cfg, lengths)
    return feat


def _blocked_from_audio(x: jnp.ndarray, cfg: FeatureConfig,
                        backend: str, apply_dct: bool,
                        row_frames: int) -> jnp.ndarray:
    """(N,) -> (T, F) via overlapping K-frame rows (C, W) — the row
    construction behind mfcc_long.
    Bit-identical to _features_from_audio: hop-aligned rows (static
    reshape + shifted-slice concat, NO gather), one dropped context slot
    per row, true pre-emphasis predecessors (row 0 carries the HTK
    x[-1] := x[0] patch), dither before blocking, deltas after
    reassembly.  cfg must be valid-mode."""
    from ..ops import deltas as deltas_op
    if cfg.dither > 0.0:
        from ..ops import dither as dither_op
        x = dither_op.apply_jax(x, cfg)
        cfg = cfg.replace(dither=0.0)
    want_deltas = cfg.deltas
    cfg = cfg.replace(deltas=False)
    N = x.shape[0]
    T = cfg.num_frames(N)
    fl, hop = cfg.frame_len, cfg.hop_len
    K = row_frames
    C = -(-T // K)
    need = C * K * hop + K * hop + fl
    head = jnp.zeros((hop - 1,), x.dtype)
    tail = jnp.zeros((max(need - (N + hop), 0),), x.dtype)
    xp = jnp.concatenate([head, x[:1], x, tail])
    base_b = xp[: C * K * hop].reshape(C, K * hop)
    ctx = xp[K * hop: (C + 1) * K * hop].reshape(C, K * hop)[:, :fl]
    rows = jnp.concatenate([base_b, ctx], axis=1)
    fr = _features_from_audio(rows, cfg, backend=backend,
                              apply_dct=apply_dct)      # (C, K+1, F)
    feat = fr[:, 1:, :].reshape(C * K, -1)[:T]
    if want_deltas:
        feat = deltas_op.append_deltas(feat, cfg)
    return feat


def mfcc(x: jnp.ndarray, cfg: FeatureConfig,
         backend: str = "auto") -> jnp.ndarray:
    """(n_samples,) PCM in [-1, 1] -> (T, n_feats) features."""
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    return _features_from_audio(x, cfg, backend=backend)


def frame_lengths(sample_lengths: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """Per-utterance true frame counts (cfg.frame_mode convention;
    zero if too short — traced twin of FeatureConfig.num_frames)."""
    if cfg.frame_mode == "center":
        t = (sample_lengths + cfg.hop_len // 2) // cfg.hop_len
        return jnp.where(sample_lengths >= cfg.center_min_samples,
                         t, 0).astype(jnp.int32)
    n = (sample_lengths - cfg.frame_len) // cfg.hop_len + 1
    return jnp.maximum(n, 0).astype(jnp.int32)


def frame_mask(T: int, flens: jnp.ndarray) -> jnp.ndarray:
    """(B, T) bool validity mask from (B,) frame counts."""
    t = jnp.arange(T, dtype=jnp.int32)
    return t[None, :] < flens[:, None]


def mfcc_batch(x: jnp.ndarray, sample_lengths: jnp.ndarray,
               cfg: FeatureConfig, backend: str = "auto"):
    """(B, N_pad), (B,) -> ((B, T, n_feats), (B,) frame counts, (B, T) mask).

    Padded-region frames are fully computed then zeroed — every shape
    stays static and every op branch-free.

    x may be int16 PCM (cast to [-1, 1) float on device — halves the
    host->device transfer) or float in [-1, 1].
    """
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    x, sample_lengths, cfg = framing.resolve_frame_mode(
        x, sample_lengths, cfg)
    flens = frame_lengths(sample_lengths, cfg)
    feat = _features_from_audio(x, cfg,
                                lengths=flens if cfg.deltas else None,
                                backend=backend)
    mask = frame_mask(feat.shape[-2], flens)
    feat = jnp.where(mask[..., None], feat, 0.0)
    return feat, flens, mask


def mfcc_batch_packed(x: jnp.ndarray, seg_starts: jnp.ndarray,
                      seg_lens: jnp.ndarray, cfg: FeatureConfig,
                      backend: str = "auto", apply_dct: bool = True,
                      family: str | None = None):
    """Packed ragged batch (utils/batch.pack_rows; VERDICT r4 #1):
    several utterances per row at hop-aligned offsets, so the padded
    program's slack carries real audio instead of zeros.

    x: (B, C) packed rows; seg_starts/seg_lens: (B, S) per-segment
    hop-aligned sample offsets and true lengths (len 0 = empty slot).
    Returns (feat (B, T, n_feats), seg_frame_starts (B, S),
    seg_frame_counts (B, S), mask (B, T)).  Segment j of row b owns
    feature rows [seg_frame_starts[b,j], +seg_frame_counts[b,j]) —
    BIT-IDENTICAL to the standalone computation of that utterance
    (hop alignment keeps every frame's samples and GEMM reduction the
    same; the packer's one-sample gap carries the pre-emphasis
    predecessor).  Frames outside every segment (gap/boundary frames)
    are zeroed; they are ~2 frames per boundary of pure overhead.

    Restrictions (raise): cfg.deltas (time-recursive across segment
    boundaries — apply deltas per utterance after splitting) and
    frame_mode="center" (per-segment reflection inside a packed row is
    not implemented); dither is positional within the packed row, so a
    dithered packed run differs from a dithered standalone run by the
    noise draw (statistically equivalent; parity tests use dither=0).
    """
    if family is None:
        family = "mfcc" if apply_dct else "logmel"
    if family not in ("mfcc", "logmel", "plp", "spec"):
        raise ValueError(f"unknown packed family {family!r}")
    if cfg.deltas:
        raise ValueError("packed batches: apply deltas per utterance "
                         "after splitting (the delta recursion would leak "
                         "across segment boundaries)")
    if cfg.frame_mode != "valid":
        raise ValueError("packed batches support frame_mode='valid' only")
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    if family == "spec":
        from . import spectrogram as spec_model
        feat = spec_model.log_spectrogram(x, cfg, backend)
    elif family == "plp":
        from . import plp as plp_model
        feat = plp_model._plp_from_audio(x, cfg, backend=backend)
    else:
        feat = _features_from_audio(x, cfg, backend=backend,
                                    apply_dct=(family == "mfcc"))
    T = feat.shape[-2]
    hop = cfg.hop_len
    f0 = seg_starts.astype(jnp.int32) // hop                    # (B, S)
    fc = frame_lengths(seg_lens, cfg) * (seg_lens > 0)          # (B, S)
    t = jnp.arange(T, dtype=jnp.int32)[None, None, :]           # (1,1,T)
    inside = (t >= f0[..., None]) & (t < (f0 + fc)[..., None])  # (B,S,T)
    mask = jnp.any(inside, axis=1)                              # (B, T)
    feat = jnp.where(mask[..., None], feat, 0.0)
    return feat, f0, fc, mask


@partial(jax.jit, static_argnames=("cfg", "backend", "apply_dct",
                                   "family"))
def mfcc_batch_packed_jit(x: jnp.ndarray, seg_starts: jnp.ndarray,
                          seg_lens: jnp.ndarray, cfg: FeatureConfig,
                          backend: str = "auto", apply_dct: bool = True,
                          family: str | None = None):
    return mfcc_batch_packed(x, seg_starts, seg_lens, cfg, backend,
                             apply_dct, family)


def mfcc_long(x: jnp.ndarray, cfg: FeatureConfig,
              backend: str = "auto", row_frames: int = 511,
              apply_dct: bool = True) -> jnp.ndarray:
    """(N,) ONE long signal -> (T, n_feats) through overlapping rows.

    Re-views the signal as C overlapping rows of ``row_frames`` frames
    each (static strided windows, one frame of left context per row —
    the blocked-Viterbi construction applied to the spectral front end),
    runs the normal batched pipeline, and reassembles with a reshape.

    BIT-IDENTICAL to mfcc(x): rows are hop-aligned so every frame reads
    the same samples through the same reductions; each row's first
    in-context sample carries its true pre-emphasis predecessor (row 0
    carries the HTK x[-1] := x[0] patch).  Deltas are applied after
    reassembly (exact); dither is applied to the whole signal before
    row building (positions match the unblocked pipeline); center
    framing resolves first.  Whether this beats the single long row on
    the GPU is not measured.
    """
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) * (1.0 / 32768.0)
    x, cfg = framing.resolve_frame_mode_static(x, cfg)
    if cfg.num_frames(x.shape[-1]) <= row_frames + 1:
        from ..ops import deltas as deltas_op
        want_deltas = cfg.deltas
        feat = _features_from_audio(x, cfg.replace(deltas=False),
                                    backend=backend, apply_dct=apply_dct)
        if want_deltas:
            feat = deltas_op.append_deltas(feat, cfg)
        return feat
    return _blocked_from_audio(x, cfg, backend, apply_dct, row_frames)


@partial(jax.jit, static_argnames=("cfg", "backend", "row_frames",
                                   "apply_dct"))
def mfcc_long_jit(x: jnp.ndarray, cfg: FeatureConfig,
                  backend: str = "auto", row_frames: int = 1024,
                  apply_dct: bool = True) -> jnp.ndarray:
    return mfcc_long(x, cfg, backend, row_frames, apply_dct)


@partial(jax.jit, static_argnames=("cfg", "backend"))
def mfcc_jit(x: jnp.ndarray, cfg: FeatureConfig,
             backend: str = "auto") -> jnp.ndarray:
    return mfcc(x, cfg, backend)


@partial(jax.jit, static_argnames=("cfg", "backend"))
def mfcc_batch_jit(x: jnp.ndarray, sample_lengths: jnp.ndarray,
                   cfg: FeatureConfig, backend: str = "auto"):
    return mfcc_batch(x, sample_lengths, cfg, backend)
