"""Streaming / chunked MFCC — online low-latency emission (config 4).

The reference's "sequence length" analog is a 1 MiB hard cap with strictly
sequential processing (``/root/reference/src/mfcc/mfcc.h:10``,
``main.c:137-141``).  Here unbounded audio streams through fixed-shape
chunks, so jit compiles exactly once and ``lax.scan`` drives long signals:

- A chunk is ``chunk_frames * hop_len`` samples (hop-aligned, static).
- State carries the last ``frame_len`` samples (enough history for any
  frame whose *end* lands in the next chunk, plus the pre-emphasis
  predecessor), the running sample count, and the emitted-frame count.
- Each step emits exactly ``chunk_frames`` feature slots plus a validity
  count: slots for frames whose final sample arrived within this chunk.
  Early in the stream fewer frames are complete; extra slots are masked.

Bit-exactness contract: feeding chunks through :func:`process_chunk`
yields exactly the frames of the batch pipeline on the concatenated
signal (tests/test_streaming.py), including pre-emphasis continuity
across chunk boundaries (the HTK x[-1] := x[0] convention is applied
once, at the true start of the stream).

Delta/CMVN post-processing is frame-local only across a ±delta_window
halo, so it is applied downstream by the consumer (or with
:func:`mfcc_tpu.ops.deltas` over a sliding window); the streaming core
emits static (or energy-substituted) cepstra.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from ..ops import spectrum, mel, dct


class StreamState(NamedTuple):
    carry: jnp.ndarray         # (frame_len,) trailing samples
    samples_seen: jnp.ndarray  # () int32
    frames_done: jnp.ndarray   # () int32  frames emitted so far


def init_state(cfg: FeatureConfig, dtype=jnp.float32) -> StreamState:
    return StreamState(
        carry=jnp.zeros((cfg.frame_len,), dtype),
        samples_seen=jnp.zeros((), jnp.int32),
        frames_done=jnp.zeros((), jnp.int32),
    )


def _num_frames_dyn(n_samples: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """Traced version of FeatureConfig.num_frames."""
    return jnp.maximum((n_samples - cfg.frame_len) // cfg.hop_len + 1, 0)


def process_chunk(state: StreamState, chunk: jnp.ndarray,
                  cfg: FeatureConfig, variant: str = "mfcc"):
    """One streaming step.

    chunk: (chunk_frames * hop_len,) new samples (static length).
    Returns (new_state, feats (chunk_frames, n_out), n_valid ()).
    Slot j holds global frame ``state.frames_done + j``; slots with
    j >= n_valid are zeroed.

    variant: "mfcc" (default), "logmel" (DCT skipped; n_out = n_mels),
    "plp" (bark + LPC cepstra), or "spec" (floored log power spectrum,
    n_out = n_bins — no mel, no DCT; models/spectrogram.py twin) —
    every frame-local pipeline streams through the same carry state,
    each matching its batch model's prefix (tests/test_streaming.py).
    """
    if variant not in ("mfcc", "logmel", "plp", "spec"):
        raise ValueError(f"unknown streaming variant {variant!r}")
    if cfg.frame_mode != "valid":
        raise ValueError(
            "streaming supports frame_mode='valid' only: the centered "
            "convention's right-edge reflection needs EOS lookahead "
            "(documented exclusion, docs/conventions.md)")
    fl, hop = cfg.frame_len, cfg.hop_len
    C = chunk.shape[0]
    if C % hop != 0:
        raise ValueError(f"chunk length {C} must be a multiple of hop {hop}")
    n_slots = C // hop
    if chunk.dtype == jnp.int16:
        chunk = chunk.astype(jnp.float32) * (1.0 / 32768.0)
    if cfg.dither > 0.0:
        # noise indexed by ABSOLUTE sample position -> bit-consistent with
        # the batch pipeline dithering the whole signal (ops/dither.py)
        from ..ops import dither as dither_op
        chunk = dither_op.apply_jax(chunk, cfg, start=state.samples_seen)

    carry = state.carry
    # stream start: pre-emphasis predecessor of sample 0 is sample 0 itself
    carry = jnp.where(state.samples_seen == 0,
                      carry.at[-1].set(chunk[0]), carry)
    buf = jnp.concatenate([carry, chunk])  # (fl + C,)

    # The streaming spectral stage IS the batch XLA engine (VERDICT r2
    # #6): no frame materialization, no 257-bin lane pad.  Pre-emphasize
    # the whole buffer once (signal convention; buf[i-1] is always the
    # true predecessor, and the x[-1] := x[0] start case is the carry
    # patch above), then hand a hop-ALIGNED dynamic slice to the same
    # split-bin hop-block dispatcher the batch path uses — slot j's
    # frame starts at slice position j*hop, exactly the batch layout.
    if cfg.preemph > 0.0:
        prev = jnp.concatenate([buf[:1], buf[:-1]])
        z = buf - jnp.asarray(cfg.preemph, buf.dtype) * prev
    else:
        z = buf
    # slot 0 (global frame frames_done) starts at buffer position
    # off0 = frames_done*hop - samples_seen + fl, which is always in
    # [1, fl] (buf[0] is global sample samples_seen - fl).  Tail slots
    # whose frames aren't complete read zero-padding and are masked.
    off0 = state.frames_done * hop - state.samples_seen + fl
    span = (n_slots - 1) * hop + fl
    zx = jnp.concatenate([z, jnp.zeros((fl - hop,), z.dtype)])
    y = jax.lax.dynamic_slice(zx, (off0,), (span,))
    p_lo, p_hi = spectrum.power_spectrum_split(y, cfg)
    if variant == "plp":
        from ..ops import plp as plp_ops
        feat = plp_ops.plp_from_power_split(p_lo, p_hi, cfg)
    elif variant == "spec":
        from ..ops import xmath
        power = jnp.concatenate([p_lo, p_hi], axis=-1)
        feat = xmath.floored_log(power, cfg.log_floor)
    else:
        logmel = mel.log_mel_energies_split(p_lo, p_hi, cfg)
        feat = logmel if variant == "logmel" else dct.cepstra(logmel, cfg)
    if cfg.append_energy and variant in ("mfcc", "plp"):
        feat = feat.at[..., 0].set(spectrum.log_energy_blocked(y, cfg))
    j = jnp.arange(n_slots, dtype=jnp.int32)

    new_seen = state.samples_seen + C
    total_frames = _num_frames_dyn(new_seen, cfg)
    n_valid = total_frames - state.frames_done
    feat = jnp.where((j < n_valid)[:, None], feat, 0.0)

    new_state = StreamState(
        carry=buf[C:],
        samples_seen=new_seen,
        frames_done=total_frames,
    )
    return new_state, feat, n_valid


@partial(jax.jit, static_argnames=("cfg", "variant"))
def process_chunk_jit(state: StreamState, chunk: jnp.ndarray,
                      cfg: FeatureConfig, variant: str = "mfcc"):
    return process_chunk(state, chunk, cfg, variant)


def init_state_batch(n_streams: int, cfg: FeatureConfig,
                     dtype=jnp.float32) -> StreamState:
    """Vectorized state for n concurrent streams."""
    return StreamState(
        carry=jnp.zeros((n_streams, cfg.frame_len), dtype),
        samples_seen=jnp.zeros((n_streams,), jnp.int32),
        frames_done=jnp.zeros((n_streams,), jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg", "variant"))
def process_chunk_batch_jit(state: StreamState, chunks: jnp.ndarray,
                            cfg: FeatureConfig, variant: str = "mfcc"):
    """Serving path: advance B concurrent streams with one device call.

    chunks: (B, chunk_frames*hop).  Single-stream streaming is dispatch-
    bound (one tiny kernel per chunk through the host); real serving runs
    many sessions, so the per-call cost amortizes across streams via vmap.
    Returns (state', feats (B, chunk_frames, n_mfcc), n_valid (B,)).
    """
    return jax.vmap(partial(process_chunk, cfg=cfg,
                            variant=variant))(state, chunks)


@partial(jax.jit, static_argnames=("cfg", "variant"))
def process_chunks_jit(state: StreamState, chunks: jnp.ndarray,
                       cfg: FeatureConfig, variant: str = "mfcc"):
    """Dispatch-amortized serving: advance ONE stream by K chunks in one
    device call (lax.scan stays resident on-chip).

    chunks: (K, chunk_frames*hop).  Batching K chunks per dispatch
    divides the per-dispatch host cost by K while adding K-1 chunk-times
    of latency — the knob between lowest latency (K=1) and highest
    single-stream throughput (large K).
    Returns (state', feats (K, chunk_frames, n_mfcc), n_valid (K,)).
    Bit-identical to K sequential process_chunk calls
    (tests/test_streaming.py).
    """
    def step(st, ch):
        st, feat, nv = process_chunk(st, ch, cfg, variant)
        return st, (feat, nv)

    final, (feats, nvs) = jax.lax.scan(step, state, chunks)
    return final, feats, nvs


@partial(jax.jit, static_argnames=("cfg", "variant"))
def process_chunks_batch_jit(state: StreamState, chunks: jnp.ndarray,
                             cfg: FeatureConfig, variant: str = "mfcc"):
    """B concurrent sessions x K chunks per dispatch: vmap over sessions
    of the on-device scan.  chunks: (B, K, chunk_frames*hop).  Returns
    (state', feats (B, K, chunk_frames, n_mfcc), n_valid (B, K))."""
    return jax.vmap(partial(process_chunks_jit, cfg=cfg,
                            variant=variant))(state, chunks)


class OnlineCmvnState(NamedTuple):
    """Carry for causal online CMVN over a feature stream: the trailing
    ``window - 1`` emitted frames in the offset-shifted domain (zeros
    before the stream starts), the count of frames absorbed so far, and
    the shift offset (the stream's first frame, captured once)."""
    buf: jnp.ndarray          # (window-1, F) trailing SHIFTED frames
    frames_seen: jnp.ndarray  # () int32
    offset: jnp.ndarray       # (F,) first stream frame (0 until captured)


def init_online_cmvn(window: int, n_feats: int,
                     dtype=jnp.float32) -> OnlineCmvnState:
    return OnlineCmvnState(
        buf=jnp.zeros((window - 1, n_feats), dtype),
        frames_seen=jnp.zeros((), jnp.int32),
        offset=jnp.zeros((n_feats,), dtype),
    )


@partial(jax.jit, static_argnames=("window", "normalize_variance"))
def online_cmvn_step(state: OnlineCmvnState, feats: jnp.ndarray,
                     n_valid: jnp.ndarray, window: int,
                     normalize_variance: bool = False, prior=None):
    """Normalize one chunk of streamed features causally (zero lookahead).

    feats: (S, F) chunk slots as emitted by process_chunk (slots past
    ``n_valid`` are zero and stay zero).  Slot j (global frame
    g = frames_seen + j) is normalized by the stats of global frames
    [max(0, g - window + 1), g] — the same contract as the batch-mode
    ops/post.online_cmvn and the float64 oracle.online_cmvn, equal to
    the batch op within f32 roundoff (~1e-5; cumsum restarts at chunk
    boundaries change the f32 summation order, so outputs may differ at
    the ulp level across chunkings — the one documented exception to the
    streaming-bit-equals-batch invariant, see docs/conventions.md;
    tests/test_post.py pins chunk-size-invariant parity at 1e-5).
    Stats run on offset-shifted data (offset = the stream's first frame,
    same cancellation-resistant formulation as the batch op).  ``prior``:
    optional (count, sum (F,), sumsq (F,)) raw stats blended while the
    window is young.  Returns (new_state, normalized (S, F)).
    """
    from ..ops.post import _blend_prior
    S, F = feats.shape
    W = window
    valid = (jnp.arange(S, dtype=jnp.int32) < n_valid)
    # capture the shift offset at the stream's first valid frame (slot 0
    # of the first chunk with n_valid > 0; stays 0 — i.e. unshifted — for
    # leading empty chunks, which emit no frames anyway)
    off = jnp.where(state.frames_seen == 0, feats[0], state.offset)
    fm = (feats - off) * valid[:, None].astype(feats.dtype)
    buf = jnp.concatenate([state.buf, fm])          # (W-1+S, F) shifted
    # rows of buf are global frames [frames_seen-(W-1), frames_seen+S);
    # slot j is row W-1+j, its causal window is rows [j, W-1+j] — a
    # static size-W slice (pre-stream rows are zeros and are excluded
    # from cnt below).
    zero = jnp.zeros((1, F), buf.dtype)
    cs = jnp.concatenate([zero, jnp.cumsum(buf, axis=0)])
    j = jnp.arange(S)
    sums = cs[W + j] - cs[j]                        # (S, F)
    g = state.frames_seen + j
    cnt = jnp.minimum(g + 1, W).astype(feats.dtype)
    if normalize_variance:
        cs2 = jnp.concatenate([zero, jnp.cumsum(buf * buf, axis=0)])
        sq = cs2[W + j] - cs2[j]
    else:
        sq = None
    cnt, sums, sq = _blend_prior(cnt, sums, sq, W, prior, offset=off)
    mean_s = sums / cnt[:, None]
    out = (feats - off) - mean_s
    if normalize_variance:
        var = jnp.maximum(sq / cnt[:, None] - mean_s * mean_s, 1e-8)
        out = out / jnp.sqrt(var)
    out = out * valid[:, None].astype(out.dtype)
    new_buf = jax.lax.dynamic_slice(
        buf, (n_valid.astype(jnp.int32), jnp.int32(0)), (W - 1, F))
    return OnlineCmvnState(buf=new_buf,
                           frames_seen=state.frames_seen + n_valid,
                           offset=off), out


@partial(jax.jit, static_argnames=("cfg", "chunk_frames", "variant"))
def stream_signal(x: jnp.ndarray, cfg: FeatureConfig,
                  chunk_frames: int = 64, variant: str = "mfcc"):
    """Whole-signal streaming via lax.scan (reference/testing path).

    x length must be a multiple of chunk_frames*hop; returns
    (feats (n_chunks*chunk_frames, n_mfcc), valid_total ()).
    """
    C = chunk_frames * cfg.hop_len
    n_chunks = x.shape[0] // C
    chunks = x[: n_chunks * C].reshape(n_chunks, C)

    def step(st, ch):
        st, feat, nv = process_chunk(st, ch, cfg, variant)
        return st, feat

    final, feats = jax.lax.scan(step, init_state(cfg, x.dtype), chunks)
    return feats.reshape(n_chunks * chunk_frames, -1), final.frames_done
