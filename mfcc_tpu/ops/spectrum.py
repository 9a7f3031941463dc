"""GEMM-native real DFT power spectrum (JAX).

The load-bearing design decision (SURVEY.md §7 step 4): instead of a
butterfly FFT, the windowed
``n_fft``-point real DFT of a ``frame_len``-sample frame is exactly

    Re[k] = sum_n  x[n] * w[n] * cos(2*pi*n*k/n_fft)
    Im[k] = -sum_n x[n] * w[n] * sin(2*pi*n*k/n_fft)      (n < frame_len)

i.e. two dense (frame_len, n_bins) matmuls with the analysis window folded
into the matrices.  At MFCC sizes (400 x 257) a dense DFT-as-GEMM runs on the
128x128 systolic array at full utilization and beats any radix decomposition
(GEMM-native NDFT; cf. the MelT / FlashFFTConv line in PAPERS.md).  Zero
padding to ``n_fft`` is implicit: rows n >= frame_len of the DFT basis are
simply never materialized.

The matrices are NumPy float64 constants built once per config and closed
over at trace time, so XLA constant-folds and keeps them resident.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FeatureConfig
from .framing import build_window


_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,       # TF32 on the GPU
    "highest": jax.lax.Precision.HIGHEST, # IEEE float32
}


def resolve_precision(cfg: FeatureConfig):
    return _PRECISIONS[cfg.matmul_precision]


@functools.lru_cache(maxsize=32)
def _dft_matrices_cached(key) -> tuple[np.ndarray, np.ndarray]:
    frame_len, n_fft, window = key
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    from .. import oracle
    w = oracle.window_fn(window, frame_len)[:, None]
    return w * np.cos(ang), w * np.sin(ang)


def dft_matrices(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """(frame_len, n_bins) float64 window-folded cos/sin DFT bases."""
    return _dft_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def _block_view(y: jnp.ndarray, block: int, n_frames: int, win: int):
    """(..., N) -> (..., R, block) non-overlapping block view with R
    guaranteed large enough that every frame's static slice
    ``blocks[..., k : k + n_frames]`` (k < ceil(win/block)) exists.

    When N isn't a multiple of ``block`` the plain floor-division view
    drops the tail partial block, which can hold samples the *last* frame
    needs (e.g. frame_len 400 / hop 160 / N 15999: frame 97 ends at sample
    15998 but R floors to 99 rows).  Zero-padding up to the needed row
    count is exact: frames never extend past ``num_frames``'s bound, so
    padded zeros are only ever multiplied into the accumulation (adding 0).
    """
    kmax = -(-win // block)                      # ceil(win / block)
    need = (max(n_frames, 1) - 1 + kmax) * block
    if y.shape[-1] < need:
        pad = [(0, 0)] * (y.ndim - 1) + [(0, need - y.shape[-1])]
        y = jnp.pad(y, pad)
    R = y.shape[-1] // block
    return y[..., : R * block].reshape(*y.shape[:-1], R, block)


def hop_block_views(y: jnp.ndarray, cfg: FeatureConfig):
    """Reshape a pre-emphasized signal into non-overlapping hop blocks.

    (..., N) -> (..., R, hop) with R >= num_frames - 1 + ceil(frame/hop).
    The hop-block decomposition below (power_spectrum_blocked) reads
    frames out of this contiguous view with *static slices only* — no
    per-frame gather.
    """
    return _block_view(y, cfg.hop_len, cfg.num_frames(y.shape[-1]),
                       cfg.frame_len)


def power_spectrum_blocked_split(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """Lane-exact variant: returns (power_lo (..., T, n_bins-1), power_hi
    (..., T, 1)) with the top (Nyquist, for even n_fft) bin split out.

    Rationale: n_bins = n_fft/2 + 1 = 257 is one column past a power of
    two, so a GEMM tiled in powers of two pads its output by a whole tile.
    The top bin costs one extra (frame_len, 1) dot (its sine column is
    identically zero for even n_fft), so computing 256 + 1 keeps the big
    GEMM at an exact power-of-two width.  Consumers either concat (power_spectrum_blocked) or
    fold the split bin directly into the mel projection
    (mel.log_mel_energies_split) without materializing the concat.
    """
    q, r = divmod(cfg.frame_len, cfg.hop_len)
    hop = cfg.hop_len
    blocks = hop_block_views(x, cfg)
    T = cfg.num_frames(x.shape[-1])
    acc = jnp.dtype(cfg.accum_dtype)
    if T <= 0:
        z = jnp.zeros((*x.shape[:-1], 0, cfg.n_bins - 1), acc)
        return z, jnp.zeros((*x.shape[:-1], 0, 1), acc)

    if precision is None:
        precision = resolve_precision(cfg)
    cos_m, sin_m = dft_matrices(cfg)
    nb = cfg.n_bins - 1
    dt = jnp.dtype(cfg.compute_dtype)
    c = jnp.asarray(cos_m[:, :nb], dt)
    s = jnp.asarray(sin_m[:, :nb], dt)
    chi = jnp.asarray(cos_m[:, nb:], dt)       # (frame_len, 1)
    shi = jnp.asarray(sin_m[:, nb:], dt)       # zero for even n_fft
    blocks = blocks.astype(dt)

    re = im = rehi = imhi = None
    even_nfft = cfg.n_fft % 2 == 0

    def acc_add(a, b):
        return b if a is None else a + b

    for k in range(q + (1 if r else 0)):
        width = hop if k < q else r
        v = blocks[..., k: k + T, :width]
        lo = k * hop
        re = acc_add(re, jnp.matmul(v, c[lo: lo + width],
                                    precision=precision))
        im = acc_add(im, jnp.matmul(v, s[lo: lo + width],
                                    precision=precision))
        rehi = acc_add(rehi, jnp.matmul(v, chi[lo: lo + width],
                                        precision=precision))
        if not even_nfft:
            imhi = acc_add(imhi, jnp.matmul(v, shi[lo: lo + width],
                                            precision=precision))
    re = re.astype(acc)
    im = im.astype(acc)
    rehi = rehi.astype(acc)
    p_lo = re * re + im * im
    p_hi = rehi * rehi
    if not even_nfft:
        imhi = imhi.astype(acc)
        p_hi = p_hi + imhi * imhi
    return p_lo, p_hi


def power_spectrum_blocked(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
) -> jnp.ndarray:
    """(..., N) raw audio -> (..., T, n_bins) |X|^2 with zero frame
    materialization (the framework's load-bearing GEMM trick).

    Because frames stride by ``hop``, the frame matrix F (T, frame_len)
    factors over hop blocks: with frame_len = q*hop + r and B2 the
    (R, hop) hop-block view of the pre-emphasized signal,

        F @ M = sum_{k<q} B2[k:k+T] @ M[k*hop:(k+1)*hop]
              + B2[q:q+T, :r] @ M[q*hop:]

    i.e. q (+1 if r>0) dense GEMMs over *contiguous static slices* — no
    (T, frame_len) gather/materialization, ~3x less HBM traffic.
    """
    q, r = divmod(cfg.frame_len, cfg.hop_len)
    hop = cfg.hop_len
    y = x  # caller applies pre-emphasis (framing.preemphasize)
    blocks = hop_block_views(y, cfg)
    T = cfg.num_frames(y.shape[-1])
    if T <= 0:
        return jnp.zeros((*y.shape[:-1], 0, cfg.n_bins), jnp.dtype(cfg.accum_dtype))

    if precision is None:
        precision = resolve_precision(cfg)
    cos_m, sin_m = dft_matrices(cfg)
    dt = jnp.dtype(cfg.compute_dtype)
    acc = jnp.dtype(cfg.accum_dtype)
    c = jnp.asarray(cos_m, dt)
    s = jnp.asarray(sin_m, dt)
    blocks = blocks.astype(dt)

    re = None
    im = None
    for k in range(q):
        v = blocks[..., k: k + T, :]
        dre = jnp.matmul(v, c[k * hop: (k + 1) * hop], precision=precision)
        dim = jnp.matmul(v, s[k * hop: (k + 1) * hop], precision=precision)
        re = dre if re is None else re + dre
        im = dim if im is None else im + dim
    if r > 0:
        v = blocks[..., q: q + T, :r]
        re = re + jnp.matmul(v, c[q * hop:], precision=precision)
        im = im + jnp.matmul(v, s[q * hop:], precision=precision)
    re = re.astype(acc)
    im = im.astype(acc)
    return re * re + im * im


def _frames_by_concat(x: jnp.ndarray, block: int, T: int,
                      n_blocks: int) -> jnp.ndarray:
    """(..., N) -> (..., T, n_blocks*block): frame t = blocks t..t+n_blocks-1
    of the non-overlapping ``block``-sample view, lane-concatenated."""
    blocks = _block_view(x, block, T, n_blocks * block)
    return jnp.concatenate(
        [blocks[..., k: k + T, :] for k in range(n_blocks)], axis=-1)


@functools.lru_cache(maxsize=32)
def _concat_basis_cached(key):
    """Direct split-bin bases with rows zero-padded from frame_len up to
    n_blocks*hop (the concat-frame K), so the trailing concat columns —
    which hold samples beyond the frame — contribute exactly zero."""
    frame_len, n_fft, window, hop = key
    cos_m, sin_m = _dft_matrices_cached((frame_len, n_fft, window))
    n_blocks = -(-frame_len // hop)
    K = n_blocks * hop
    pad = ((0, K - frame_len), (0, 0))
    return np.pad(cos_m, pad), np.pad(sin_m, pad)


def power_spectrum_direct_concat(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """"directc": split-bin direct DFT over concat-materialized frames.

    Same numbers as power_spectrum_blocked_split, different GEMM shape:
    instead of q+1 GEMMs with K=hop each, ONE (T, ceil(frame/hop)*hop) @
    (K, n_fft/2) GEMM per component.  The frame matrix is materialized in
    device memory by a concat of static slices (no gather), trading ~4x
    more input bytes for one large contraction.
    """
    hop = cfg.hop_len
    T = cfg.num_frames(x.shape[-1])
    acc = jnp.dtype(cfg.accum_dtype)
    if T <= 0:
        z = jnp.zeros((*x.shape[:-1], 0, cfg.n_bins - 1), acc)
        return z, jnp.zeros((*x.shape[:-1], 0, 1), acc)
    if precision is None:
        precision = resolve_precision(cfg)
    cos_m, sin_m = _concat_basis_cached(
        (cfg.frame_len, cfg.n_fft, cfg.window, hop))
    n_blocks = -(-cfg.frame_len // hop)
    frames = _frames_by_concat(x, hop, T, n_blocks)
    dt = jnp.dtype(cfg.compute_dtype)
    frames = frames.astype(dt)
    nb = cfg.n_bins - 1
    c = jnp.asarray(cos_m[:, :nb], dt)
    s = jnp.asarray(sin_m[:, :nb], dt)
    chi = jnp.asarray(cos_m[:, nb:], dt)
    shi = jnp.asarray(sin_m[:, nb:], dt)
    re = jnp.matmul(frames, c, precision=precision).astype(acc)
    im = jnp.matmul(frames, s, precision=precision).astype(acc)
    rehi = jnp.matmul(frames, chi, precision=precision).astype(acc)
    p_lo = re * re + im * im
    p_hi = rehi * rehi
    if cfg.n_fft % 2 != 0:
        imhi = jnp.matmul(frames, shi, precision=precision).astype(acc)
        p_hi = p_hi + imhi * imhi
    return p_lo, p_hi


def _dit_combine(E, e_last, O, o_last, cfg: FeatureConfig):
    """Shared radix-2 twiddle-combine epilogue: per-parity half-length DFT
    outputs (packed [cos | sin] + real Nyquist column) -> (p_lo, p_hi)."""
    acc = jnp.dtype(cfg.accum_dtype)
    _, _, ct, st = dit_matrices(cfg)
    nb2 = (cfg.n_fft // 2) // 2
    ctj = jnp.asarray(ct, acc)
    stj = jnp.asarray(st, acc)
    e_re, e_im = E[..., :nb2], E[..., nb2:]
    o_re, o_im = O[..., :nb2], O[..., nb2:]
    # B = W^j O[j] with the GEMMs producing (sum x cos, sum x sin) pairs:
    # E[j] = e_re - i*e_im, O[j] = o_re - i*o_im, W^j = cos - i*sin.
    b_re = ctj * o_re - stj * o_im
    b_im = ctj * o_im + stj * o_re
    p_plus = (e_re + b_re) ** 2 + (e_im + b_im) ** 2     # bins 0..nb2-1
    p_minus = (e_re - b_re) ** 2 + (e_im - b_im) ** 2    # bins n_fft/2 - j
    mid = e_last * e_last + o_last * o_last              # bin nb2 (E,O real)
    p_lo = jnp.concatenate(
        [p_plus, mid, jnp.flip(p_minus[..., 1:], axis=-1)], axis=-1)
    return p_lo, p_minus[..., :1]


@functools.lru_cache(maxsize=32)
def _dit_concat_basis_cached(key):
    """Per-parity DIT bases (basis, last) row-padded from the stream length
    up to n_blocks*hop2 for the concat-frame GEMM."""
    frame_len, n_fft, window, hop2 = key
    (be, bel), (bo, bol), _ct, _st = _dit_matrices_cached(
        (frame_len, n_fft, window))
    out = []
    for basis, last in ((be, bel), (bo, bol)):
        L = basis.shape[0]
        K = -(-L // hop2) * hop2
        pad = ((0, K - L), (0, 0))
        out.append((np.pad(basis, pad), np.pad(last, pad)))
    return out[0], out[1]


def power_spectrum_dit_concat(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """"dit2c": radix-2 DIT over concat-materialized parity-stream frames.

    The minimal-MAC formulation with one contraction per parity stream:
    ONE (T, ceil(L/hop2)*hop2) @ (K, n_fft/2) GEMM (+ rank-1 Nyquist) —
    vs dit2's per-block GEMMs with K = hop/2.  2.0x fewer true MACs than
    direct, with the twiddle combine fused into the GEMM epilogue by XLA.
    """
    if not dit_eligible(cfg):
        raise ValueError("dit2c requires n_fft % 4 == 0 and even hop_len")
    hop2 = cfg.hop_len // 2
    T = cfg.num_frames(x.shape[-1])
    acc = jnp.dtype(cfg.accum_dtype)
    if T <= 0:
        z = jnp.zeros((*x.shape[:-1], 0, cfg.n_bins - 1), acc)
        return z, jnp.zeros((*x.shape[:-1], 0, 1), acc)
    if precision is None:
        precision = resolve_precision(cfg)
    (be, bel), (bo, bol) = _dit_concat_basis_cached(
        (cfg.frame_len, cfg.n_fft, cfg.window, hop2))
    dt = jnp.dtype(cfg.compute_dtype)

    outs = []
    for s, basis, blast in ((0, be, bel), (1, bo, bol)):
        d = x[..., s::2]
        n_blocks = basis.shape[0] // hop2
        frames = _frames_by_concat(d, hop2, T, n_blocks).astype(dt)
        B = jnp.asarray(basis, dt)
        BL = jnp.asarray(blast, dt)
        main = jnp.matmul(frames, B, precision=precision)
        last = jnp.matmul(frames, BL, precision=precision)
        outs.append((main.astype(acc), last.astype(acc)))
    (E, e_last), (O, o_last) = outs
    return _dit_combine(E, e_last, O, o_last, cfg)


@functools.lru_cache(maxsize=32)
def _dit4_matrices_cached(key):
    """Two-stage Cooley-Tukey bases: per sample-residue stream (mod 4),
    the window-folded quarter-length (n_fft/4-point) real-DFT basis packed
    [cos | sin] (nb4 = n_fft/8 bins each) + the real Nyquist column
    ((-1)^m), rows zero-padded to n_blocks*hop4 for the concat-frame GEMM;
    plus the level-1 twiddles e^{-2*pi*i*j/(n_fft/2)} for j < n_fft/4."""
    frame_len, n_fft, window, hop4 = key
    N4 = n_fft // 4
    nb4 = N4 // 2
    from .. import oracle
    w = oracle.window_fn(window, frame_len)
    streams = []
    for s in range(4):
        ws = w[s::4]
        m = np.arange(ws.shape[0], dtype=np.float64)[:, None]
        j = np.arange(nb4, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * m * j / N4
        basis = np.concatenate(
            [ws[:, None] * np.cos(ang), ws[:, None] * np.sin(ang)], axis=1)
        last = (ws * np.cos(np.pi * m[:, 0]))[:, None]
        L = basis.shape[0]
        K = -(-L // hop4) * hop4
        pad = ((0, K - L), (0, 0))
        streams.append((np.pad(basis, pad), np.pad(last, pad)))
    nb2 = (n_fft // 2) // 2
    th = 2.0 * np.pi * np.arange(nb2, dtype=np.float64) / (n_fft // 2)
    return tuple(streams), np.cos(th), np.sin(th)


def dit4_eligible(cfg: FeatureConfig) -> bool:
    """Delegates to FeatureConfig.dit4_eligible (single source of truth)."""
    return cfg.dit4_eligible


def _quarter_to_half(re, im, last):
    """Extend a quarter-DFT's distinct bins to the N4-periodic lane range
    a radix-2 level-1 combine needs: stored (sum x cos, sum x sin) GEMM
    outputs for j < nb4 plus the real Nyquist bin -> (re, im) over
    j = 0..2*nb4-1 using conjugate symmetry S[N4-j] = conj(S[j]) (in the
    stored convention X = re - i*im, conj negates im)."""
    re_hi = jnp.flip(re[..., 1:], axis=-1)          # lanes nb4+1..2*nb4-1
    im_hi = -jnp.flip(im[..., 1:], axis=-1)
    re_f = jnp.concatenate([re, last, re_hi], axis=-1)
    im_f = jnp.concatenate([im, jnp.zeros_like(last), im_hi], axis=-1)
    return re_f, im_f


def power_spectrum_dit4_concat(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """"dit4c": two-stage Cooley-Tukey (radix-4 DIT) GEMM DFT over
    concat-materialized frames (VERDICT r1 item 10).

    Decimate frame samples by residue mod 4; with S_s the window-folded
    n_fft/4-point real DFT of stream s and W = e^{-2*pi*i/n_fft}:

        E[j] = S_0[j] + W^{2j} S_2[j]      (n_fft/2-point DFT, even samples)
        O[j] = S_1[j] + W^{2j} S_3[j]      (odd samples)
        X[j] / X[n_fft/2 - j] via the radix-2 combine of E, O

    so the device sees FOUR (T, ceil(L/4/hop4)*hop4) @ (K, n_fft/4) GEMMs:
    3.3x fewer true MACs than the direct DFT (61k vs 205k per 25/10 ms
    frame).  The price is two levels of elementwise twiddle combines plus
    the conjugate-symmetry flips that extend each quarter DFT to
    half-DFT range — relayouts that XLA materializes through HBM.
    Measured on device before any default change (the reference repo's
    lesson: behavior-level measurement is the oracle, /root/reference/
    test/run.sh; a declared-but-unmeasured default is its ignored
    `target` param all over again).
    """
    if not dit4_eligible(cfg):
        raise ValueError(
            "dit4c requires n_fft % 8 == 0 and hop_len % 4 == 0")
    hop4 = cfg.hop_len // 4
    T = cfg.num_frames(x.shape[-1])
    acc = jnp.dtype(cfg.accum_dtype)
    if T <= 0:
        z = jnp.zeros((*x.shape[:-1], 0, cfg.n_bins - 1), acc)
        return z, jnp.zeros((*x.shape[:-1], 0, 1), acc)
    if precision is None:
        precision = resolve_precision(cfg)
    streams, c2, s2 = _dit4_matrices_cached(
        (cfg.frame_len, cfg.n_fft, cfg.window, hop4))
    dt = jnp.dtype(cfg.compute_dtype)
    nb4 = (cfg.n_fft // 4) // 2

    outs = []
    for s in range(4):
        basis, blast = streams[s]
        d = x[..., s::4]
        n_blocks = max(basis.shape[0] // hop4, 1)
        frames = _frames_by_concat(d, hop4, T, n_blocks).astype(dt)
        B = jnp.asarray(basis, dt)
        BL = jnp.asarray(blast, dt)
        main = jnp.matmul(frames, B, precision=precision).astype(acc)
        last = jnp.matmul(frames, BL, precision=precision).astype(acc)
        outs.append((main, last))

    def full(main, last):
        return _quarter_to_half(main[..., :nb4], main[..., nb4:], last)

    a_re, a_im = full(*outs[0])
    b_re, b_im = full(*outs[1])
    c_re, c_im = full(*outs[2])
    d_re, d_im = full(*outs[3])
    cw = jnp.asarray(c2, acc)
    sw = jnp.asarray(s2, acc)
    # level-1 twiddle combine in the stored (sum cos, sum sin) convention:
    # (c_re - i c_im)(cw - i sw) -> re' = cw*c_re - sw*c_im,
    #                               im' = sw*c_re + cw*c_im
    E = jnp.concatenate([a_re + cw * c_re - sw * c_im,
                         a_im + sw * c_re + cw * c_im], axis=-1)
    O = jnp.concatenate([b_re + cw * d_re - sw * d_im,
                         b_im + sw * d_re + cw * d_im], axis=-1)
    # E[n_fft/4] = S_0[0] - S_2[0] (W^{2*nb2} = -1; bin 0 of each quarter
    # DFT is real = lane 0 of the cos half)
    e_last = outs[0][0][..., 0:1] - outs[2][0][..., 0:1]
    o_last = outs[1][0][..., 0:1] - outs[3][0][..., 0:1]
    return _dit_combine(E, e_last, O, o_last, cfg)


@functools.lru_cache(maxsize=32)
def _dit_matrices_cached(key):
    """Radix-2 DIT bases: per sample-parity stream, the window-folded
    half-length (n_fft/2-point) real-DFT basis, packed [cos | sin] so one
    GEMM per stream emits Re and Im together in exactly n_fft/2 lanes."""
    frame_len, n_fft, window = key
    N2 = n_fft // 2
    nb2 = N2 // 2            # bins 0..nb2-1 in the GEMM; bin nb2 is rank-1
    from .. import oracle
    w = oracle.window_fn(window, frame_len)
    streams = []
    for s in (0, 1):
        ws = w[s::2]
        m = np.arange(ws.shape[0], dtype=np.float64)[:, None]
        j = np.arange(nb2, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * m * j / N2
        basis = np.concatenate(
            [ws[:, None] * np.cos(ang), ws[:, None] * np.sin(ang)], axis=1)
        # bin nb2 of the half DFT: e^{-2*pi*i*m*nb2/N2} = (-1)^m (real)
        last = (ws * np.cos(np.pi * m[:, 0]))[:, None]
        streams.append((basis, last))
    th = 2.0 * np.pi * np.arange(nb2, dtype=np.float64) / n_fft
    return streams[0], streams[1], np.cos(th), np.sin(th)


def dit_matrices(cfg: FeatureConfig):
    return _dit_matrices_cached((cfg.frame_len, cfg.n_fft, cfg.window))


def dit_eligible(cfg: FeatureConfig) -> bool:
    """Delegates to FeatureConfig.dit2_eligible (single source of truth)."""
    return cfg.dit2_eligible


def resolve_dft_algorithm(cfg: FeatureConfig) -> str:
    """"auto" -> "direct".  Radix-2 halves true MACs, but the DIT
    variants add parity deinterleave / frame concat / bin-reorder
    relayouts; which factorization wins on the GPU is not measured yet.
    """
    algo = getattr(cfg, "dft_algorithm", "auto")
    if algo == "auto":
        return "direct"
    return algo


def power_spectrum_dit_split(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """Radix-2 decimation-in-time GEMM DFT — half the MACs of the
    direct form, same (p_lo, p_hi) contract as power_spectrum_blocked_split.

    Split frame samples by parity: with E, O the window-folded n_fft/2-point
    real DFTs of the even/odd sample streams and W = e^{-2*pi*i/n_fft},

        X[j]         = E[j] + W^j O[j]            j = 0..n_fft/4
        X[n_fft/2-j] = conj(E[j] - W^j O[j])      j = 0..n_fft/4

    so |X|^2 over all n_fft/2+1 bins comes from TWO (L/2, n_fft/2)-lane
    GEMMs (vs two (L, n_fft/2) ones) plus an elementwise twiddle combine
    that XLA fuses into the GEMM epilogue: exactly 2.0x fewer MACs at the
    precision-mandated (HIGHEST) matmul rate.  Each stream reuses the hop-block
    decomposition with hop/2-sample blocks — still no frame
    materialization.  The half-DFT Nyquist bin (basis (-1)^m, sine
    identically zero) rides as a rank-1 update, keeping the big GEMM at
    exactly n_fft/2 lanes, like the split-bin direct path.
    """
    if not dit_eligible(cfg):
        raise ValueError("dit2 requires n_fft % 4 == 0 and even hop_len")
    hop2 = cfg.hop_len // 2
    T = cfg.num_frames(x.shape[-1])
    acc = jnp.dtype(cfg.accum_dtype)
    if T <= 0:
        z = jnp.zeros((*x.shape[:-1], 0, cfg.n_bins - 1), acc)
        return z, jnp.zeros((*x.shape[:-1], 0, 1), acc)
    if precision is None:
        precision = resolve_precision(cfg)
    (be, bel), (bo, bol), ct, st = dit_matrices(cfg)
    dt = jnp.dtype(cfg.compute_dtype)

    outs = []
    for s, basis, blast in ((0, be, bel), (1, bo, bol)):
        d = x[..., s::2]
        Ls = basis.shape[0]
        blocks = _block_view(d, hop2, T, Ls).astype(dt)
        q, r = divmod(Ls, hop2)
        B = jnp.asarray(basis, dt)
        BL = jnp.asarray(blast, dt)
        main = last = None
        for k in range(q + (1 if r else 0)):
            width = hop2 if k < q else r
            v = blocks[..., k: k + T, :width]
            lo = k * hop2
            dm = jnp.matmul(v, B[lo: lo + width], precision=precision)
            dl = jnp.matmul(v, BL[lo: lo + width], precision=precision)
            main = dm if main is None else main + dm
            last = dl if last is None else last + dl
        outs.append((main.astype(acc), last.astype(acc)))

    (E, e_last), (O, o_last) = outs
    return _dit_combine(E, e_last, O, o_last, cfg)


def power_spectrum_split(
    x: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
):
    """Algorithm dispatcher for the batch spectral stage (split contract).

    cfg.dft_algorithm ("auto" resolves via resolve_dft_algorithm):
    - "direct"  hop-block GEMM chain, split-bin (no frame materialization)
    - "directc" direct DFT over concat-materialized frames (one big GEMM)
    - "dit2"    radix-2 DIT hop-block chain (2x fewer true MACs)
    - "dit2c"   radix-2 DIT over concat frames (2x fewer MACs, one
                contraction per parity stream)
    - "dit4c"   two-stage Cooley-Tukey over concat frames (3.3x fewer
                true MACs; two twiddle levels)
    """
    algo = resolve_dft_algorithm(cfg)
    fn = {"direct": power_spectrum_blocked_split,
          "directc": power_spectrum_direct_concat,
          "dit2": power_spectrum_dit_split,
          "dit2c": power_spectrum_dit_concat,
          "dit4c": power_spectrum_dit4_concat}[algo]
    return fn(x, cfg, precision=precision)


def log_energy_blocked(y: jnp.ndarray, cfg: FeatureConfig) -> jnp.ndarray:
    """(..., N) pre-emphasized audio -> (..., T) floored log frame energy,
    via the same hop-block decomposition (no frame materialization)."""
    from . import xmath
    q, r = divmod(cfg.frame_len, cfg.hop_len)
    blocks = hop_block_views(y, cfg)
    T = cfg.num_frames(y.shape[-1])
    sq = blocks * blocks
    row = jnp.sum(sq, axis=-1)                    # (..., R)
    e = None
    for k in range(q):
        v = row[..., k: k + T]
        e = v if e is None else e + v
    if r > 0:
        e = e + jnp.sum(sq[..., q: q + T, :r], axis=-1)
    return xmath.floored_log(e.astype(jnp.float32), cfg.log_floor)


def power_spectrum(
    frames: jnp.ndarray,
    cfg: FeatureConfig,
    *,
    precision=None,
) -> jnp.ndarray:
    """(..., T, frame_len) pre-emphasized frames -> (..., T, n_bins) |X|^2.

    float32 accumulation with HIGHEST matmul precision by default: a TF32
    or single bf16 pass has ~2^-11..2^-8 relative error which, pushed
    through log(), blows the 1e-4 feature tolerance; HIGHEST keeps full
    f32 fidelity.
    """
    if precision is None:
        precision = resolve_precision(cfg)
    cos_m, sin_m = dft_matrices(cfg)
    dt = jnp.dtype(cfg.compute_dtype)
    c = jnp.asarray(cos_m, dt)
    s = jnp.asarray(sin_m, dt)
    f = frames.astype(dt)
    re = jnp.matmul(f, c, precision=precision)
    im = jnp.matmul(f, s, precision=precision)
    acc = jnp.dtype(cfg.accum_dtype)
    re = re.astype(acc)
    im = im.astype(acc)
    return re * re + im * im
