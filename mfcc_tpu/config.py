"""Feature-extraction configuration.

The reference compiler's entire configuration surface is a single ignored
``BuildTargetType`` enum plus hardcoded constants (``/root/reference/src/mfcc/
mfcc.h:15-21``, ``main.c:107``).  This framework replaces that with one frozen
dataclass that fully determines the numerical contract of the pipeline: every
stage (framing, window, DFT, mel, log, DCT, deltas, CMVN) reads only from this
object, and a stable hash of it is recorded alongside emitted features so runs
are reproducible.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional


# Window types supported by build_window() in ops/framing.py.
WINDOWS = ("hamming", "hann", "povey", "rect")
# Framing conventions supported by ops/framing.py (see FeatureConfig).
FRAME_MODES = ("valid", "center")
# Mel-scale conventions supported by ops/mel.py.
MEL_SCALES = ("htk", "slaney")
# DFT factorizations supported by ops/spectrum.py (batch path).
DFT_ALGORITHMS = ("auto", "direct", "directc", "dit2", "dit2c", "dit4c")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Frozen numerical contract for the MFCC / log-mel front-end.

    Defaults give the classic 16 kHz, 25 ms / 10 ms, MFCC-13 front-end from
    the project baseline (BASELINE.json `metric`).
    """

    # --- sampling / framing ---------------------------------------------
    sample_rate: int = 16_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    # Framing convention (r5, Kaldi/librosa interop):
    #   "valid"  — the original contract: frame t covers samples
    #              [t*hop, t*hop + frame_len), last partial frame dropped,
    #              no padding (Kaldi snip_edges=true).
    #   "center" — Kaldi snip_edges=false placement: T = (n + hop/2)//hop
    #              frames, frame t starts at t*hop + hop//2 - frame_len//2,
    #              out-of-range samples filled by symmetric reflection WITH
    #              edge duplication (Kaldi ExtractWindow; librosa
    #              pad_mode="symmetric" class).  Implemented as a reflect
    #              pad of the raw (post-dither) signal followed by the
    #              exact "valid" pipeline, so every feature family
    #              inherits it unchanged.  Pre-emphasis stays this framework's
    #              signal-level convention (applied to the padded
    #              signal), a documented deviation from Kaldi's
    #              per-window pre-emphasis (docs/conventions.md).
    #              Signals shorter than ceil(frame_len/2) emit 0 frames
    #              (Kaldi would reflect-tile them; documented deviation —
    #              such inputs are the valid-mode quarantine class).
    #              Streaming supports "valid" only (the right-edge
    #              reflection needs EOS lookahead).
    # NOTE: adding this field renamed config_hash for ALL configs at r5
    # (the hash names the full numerical contract; docs/conventions.md).
    frame_mode: str = "valid"
    # --- spectral --------------------------------------------------------
    n_fft: int = 512
    window: str = "hamming"
    preemph: float = 0.97          # 0.0 disables pre-emphasis
    # seeded reproducible waveform dither (ops/dither.py): noise RMS in
    # input units ([-1, 1] floats); Kaldi's default "1 LSB of int16" is
    # dither.KALDI_ONE_LSB (~3.05e-5).  0.0 disables (default).  Applied
    # identically (same seed, same counter-based generator) in the oracle
    # and every pipeline, so parity tests bind with dither on.
    dither: float = 0.0
    dither_seed: int = 0
    # --- mel -------------------------------------------------------------
    n_mels: int = 26
    fmin: float = 0.0
    fmax: Optional[float] = None   # None -> Nyquist
    mel_scale: str = "htk"
    # Vocal-tract-length normalization: piecewise-linear frequency warp
    # applied to the mel filter edge frequencies (oracle.vtln_warp_freq;
    # standard Kaldi-convention warp — identity in [fmin, vtln_low*max(1,a)]
    # -> scaled by 1/a in the mid band -> identity again at fmax).  1.0
    # disables.  vtln_high < 0 means "offset from fmax" (so the default
    # -500 tracks the Nyquist).  Warping only reshapes the constant
    # filterbank matrix, so every path (batch, streaming) inherits it
    # with zero device-side cost.
    vtln_warp: float = 1.0
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    # --- cepstral --------------------------------------------------------
    n_mfcc: int = 13
    log_floor: float = 1e-10       # absolute floor inside log(max(E, floor))
    # optional per-frame RELATIVE floor: mel energies below
    # max_over_bands / 10^(dynamic_range_db/10) are floored.  Caps the
    # dynamic range the log stage must resolve — deep spectral valleys are
    # where float32 summation error exceeds the 1e-4 feature tolerance
    # (docs/conventions.md accuracy policy).
    # None = unlimited range (classic definition, the default).
    dynamic_range_db: Optional[float] = None
    lifter: int = 0                # 0 disables cepstral liftering
    append_energy: bool = False    # replace c0 with log frame energy
    # --- PLP (models/plp.py; ignored by the MFCC/log-mel pipelines) ------
    n_bark: int = 21               # critical-band filters (Hermansky bark)
    lpc_order: int = 12            # all-pole model order
    # NOTE: adding these fields changed config_hash for ALL configs at
    # round 2 (documented in docs/conventions.md — the hash names the
    # full numerical contract, so growing the contract renames it).
    # --- post ------------------------------------------------------------
    deltas: bool = False           # append delta + delta-delta
    delta_window: int = 2
    cmvn: bool = False             # per-corpus cepstral mean/var norm
    # --- numerics --------------------------------------------------------
    compute_dtype: str = "float32"   # "float32" | "bfloat16" (matmul inputs)
    accum_dtype: str = "float32"     # accumulation dtype (keep float32)
    # Precision of the spectral GEMMs (jax.lax.Precision).  On an H100
    # (chip_smoke.py, MFCC-13 at (64, 10 s) vs the float64 oracle):
    # "highest": IEEE float32 — 1.84e-5 max abs error, the contract
    #            default
    # "high":    TF32 on the GPU — 1.12e-2 error
    # "default": TF32 on the GPU — 1.12e-2 error
    # Only "highest" meets the 1e-4 contract; the others are for
    # consumers that tolerate TF32-class spectra.
    matmul_precision: str = "highest"
    # Batch-path DFT factorization (ops/spectrum.py):
    #   "direct"  window-folded hop-block GEMM chain, no frame
    #             materialization (the default)
    #   "directc" direct DFT over concat-materialized frames
    #   "dit2"    radix-2 decimation-in-time hop-block chain — two
    #             half-length real DFTs (one per sample parity) +
    #             elementwise twiddle combine, 2.0x fewer MACs
    #   "dit2c"   radix-2 DIT over concat frames
    #   "dit4c"   two-stage Cooley-Tukey (radix-4 DIT) over concat
    #             frames — 4 quarter-length real DFTs + two twiddle
    #             levels, 3.3x fewer true MACs than direct
    # All are numerically equivalent at HIGHEST precision (oracle-parity
    # tested, tests/test_spectrum_algorithms.py).  "auto" resolves to
    # "direct" — see resolve_dft_algorithm; which one is fastest on the
    # GPU is not measured yet.  Streaming
    # uses the frames path (same direct bases), so batch-vs-streaming
    # parity is at f32 roundoff under auto (tests/test_streaming.py).
    dft_algorithm: str = "auto"

    # --- derived sizes ---------------------------------------------------
    @property
    def frame_len(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def hop_len(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))

    @property
    def n_bins(self) -> int:
        """Number of non-redundant rFFT bins."""
        return self.n_fft // 2 + 1

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2.0 if self.fmax is None else float(self.fmax)

    @property
    def vtln_high_hz(self) -> float:
        """vtln_high resolved to Hz (negative = offset below fmax)."""
        return (self.fmax_hz + self.vtln_high if self.vtln_high < 0.0
                else self.vtln_high)

    @property
    def n_feats(self) -> int:
        """Final feature dimension (after optional deltas)."""
        base = self.n_mfcc
        return base * 3 if self.deltas else base

    @property
    def dit2_eligible(self) -> bool:
        """Radix-2 DIT needs an even hop (so every frame start maps to a
        whole index in each parity stream), n_fft % 4 == 0 (so the
        half-length DFT has a real Nyquist bin the rank-1 column can
        carry), and at least 2 samples per frame.  Single source of truth
        — ops/spectrum.dit_eligible delegates here so validate() and the
        dispatcher can't drift (ADVICE r1)."""
        return (self.n_fft % 4 == 0 and self.hop_len % 2 == 0
                and self.frame_len >= 2)

    @property
    def dit4_eligible(self) -> bool:
        """Two-stage Cooley-Tukey (radix-4 DIT) needs hop divisible by 4
        (frame starts map to whole indices in all four sample-parity
        streams), n_fft % 8 == 0 (the quarter-length DFT has a real
        Nyquist bin), and at least 4 samples per frame.  Single source of
        truth for validate() and ops/spectrum.dit4_eligible."""
        return (self.n_fft % 8 == 0 and self.hop_len % 4 == 0
                and self.frame_len >= 4)

    @property
    def center_left_pad(self) -> int:
        """Center mode: samples reflected before the signal start (frame 0
        begins at original position -center_left_pad)."""
        return self.frame_len // 2 - self.hop_len // 2

    @property
    def center_min_samples(self) -> int:
        """Center mode: shortest signal that emits frames (= the maximum
        right overhang, ceil(frame_len/2) — single-bounce reflection)."""
        return self.frame_len - self.frame_len // 2

    def num_frames(self, n_samples: int) -> int:
        """Frames emitted for an ``n_samples``-long signal.

        "valid": the last partial frame is dropped; no padding.  This
        keeps every stage static-shape under jit.  A signal shorter than
        one frame yields zero frames.
        "center": Kaldi snip_edges=false count (n + hop//2) // hop, except
        signals shorter than ceil(frame_len/2) yield zero frames (see the
        frame_mode field note).
        """
        if self.frame_mode == "center":
            if n_samples < self.center_min_samples:
                return 0
            return (n_samples + self.hop_len // 2) // self.hop_len
        if n_samples < self.frame_len:
            return 0
        return 1 + (n_samples - self.frame_len) // self.hop_len

    def validate(self) -> "FeatureConfig":
        if self.window not in WINDOWS:
            raise ValueError(f"window must be one of {WINDOWS}, got {self.window!r}")
        if self.frame_mode not in FRAME_MODES:
            raise ValueError(f"frame_mode must be one of {FRAME_MODES}, "
                             f"got {self.frame_mode!r}")
        if self.frame_mode == "center" and self.hop_len > self.frame_len:
            raise ValueError("frame_mode='center' requires hop_len <= "
                             "frame_len (centered windows must overlap or "
                             "tile; gapped framing has no centered "
                             "convention)")
        if self.mel_scale not in MEL_SCALES:
            raise ValueError(
                f"mel_scale must be one of {MEL_SCALES}, got {self.mel_scale!r}")
        if self.n_fft < self.frame_len:
            raise ValueError(
                f"n_fft ({self.n_fft}) must be >= frame_len ({self.frame_len})")
        if self.n_mfcc > self.n_mels:
            raise ValueError("n_mfcc must be <= n_mels")
        if not (0.0 <= self.preemph < 1.0):
            raise ValueError("preemph must be in [0, 1)")
        if self.dither < 0.0:
            raise ValueError("dither must be >= 0")
        if self.fmax is not None and self.fmax <= self.fmin:
            raise ValueError("fmax must be > fmin")
        if self.vtln_warp <= 0.0:
            raise ValueError("vtln_warp must be > 0")
        if self.vtln_warp != 1.0:
            l = self.vtln_low * max(1.0, self.vtln_warp)
            h = self.vtln_high_hz * min(1.0, self.vtln_warp)
            if not (self.fmin < l < h < self.fmax_hz):
                raise ValueError(
                    "VTLN needs fmin < vtln_low*max(1,warp) < "
                    "vtln_high*min(1,warp) < fmax "
                    f"(got fmin={self.fmin}, l={l}, h={h}, "
                    f"fmax={self.fmax_hz})")
            # monotonicity of the piecewise-linear warp also needs the RAW
            # cutoffs strictly inside [fmin, fmax] (Kaldi asserts the same):
            # e.g. vtln_high_hz > fmax makes scale_right < 0 — a silently
            # non-monotonic warp and corrupt filterbank.
            if not (self.fmin < self.vtln_low
                    and self.vtln_high_hz < self.fmax_hz):
                raise ValueError(
                    "VTLN needs fmin < vtln_low and vtln_high < fmax "
                    f"(got fmin={self.fmin}, vtln_low={self.vtln_low}, "
                    f"vtln_high_hz={self.vtln_high_hz}, "
                    f"fmax={self.fmax_hz})")
        if self.n_bark < 2:
            raise ValueError("n_bark must be >= 2")
        if not (1 <= self.lpc_order < self.n_bark + 2):
            raise ValueError(
                "lpc_order must be in [1, n_bark + 1] (the autocorrelation "
                "IDFT provides n_bark + 2 spectral samples)")
        if self.dft_algorithm not in DFT_ALGORITHMS:
            raise ValueError(
                f"dft_algorithm must be one of {DFT_ALGORITHMS}, "
                f"got {self.dft_algorithm!r}")
        if self.dft_algorithm in ("dit2", "dit2c") and not self.dit2_eligible:
            raise ValueError(
                f"dft_algorithm={self.dft_algorithm!r} requires n_fft % 4 "
                "== 0, an even hop_len, and frame_len >= 2 (use 'auto' to "
                "fall back automatically)")
        if self.dft_algorithm == "dit4c" and not self.dit4_eligible:
            raise ValueError(
                "dft_algorithm='dit4c' requires n_fft % 8 == 0, hop_len % 4 "
                "== 0, and frame_len >= 4 (use 'auto' to fall back "
                "automatically)")
        return self

    # --- reproducibility -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def config_hash(self) -> str:
        """Stable short hash of the numerical contract, recorded in outputs."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def replace(self, **kw) -> "FeatureConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    """Frozen numerical contract for the pitch front-end (models/pitch.py).

    NCCF + Viterbi pitch tracking in the Kaldi style (Ghahremani et al.,
    "A pitch extraction algorithm tuned for ASR", 2014), with conventions
    adapted to this framework's GEMM-native stages — exact definitions in
    docs/conventions.md.  A separate dataclass (not FeatureConfig fields)
    because pitch is an independent front-end with its own contract and
    growing FeatureConfig renames every existing config_hash.
    """

    sample_rate: int = 16_000
    # processing rate: the input is polyphase-resampled here first, which
    # also provides the anti-alias lowpass at work_rate/2 (Kaldi separately
    # lowpasses at 1 kHz; work_rate=2000 reproduces that exactly, 4000
    # keeps more band and twice the lag resolution — the default)
    work_rate: int = 4_000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    min_f0: float = 50.0           # lowest lag ~ work_rate / min_f0
    max_f0: float = 400.0          # highest lag ~ work_rate / max_f0
    penalty: float = 0.35          # Viterbi cost: penalty * dlog(lag)^2
    ballast: float = 1.0           # silence suppression, x mean_energy^2
    norm_window: int = 151         # POV^2-weighted log-pitch mean window
    delta_window: int = 2          # delta-log-pitch regression window

    @property
    def frame_len_w(self) -> int:
        return int(round(self.work_rate * self.frame_ms / 1000.0))

    @property
    def hop_len_w(self) -> int:
        return int(round(self.work_rate * self.hop_ms / 1000.0))

    @property
    def min_lag(self) -> int:
        return max(2, math.ceil(self.work_rate / self.max_f0))

    @property
    def max_lag(self) -> int:
        return int(self.work_rate // self.min_f0)

    @property
    def n_lags(self) -> int:
        return self.max_lag - self.min_lag + 1

    @property
    def n_feats(self) -> int:
        return 3                   # [pov, normalized log pitch, delta]

    def num_frames(self, n_samples: int) -> int:
        """Pitch frames for an ``n_samples``-long signal at sample_rate.

        "Valid" framing at the work rate: each frame needs frame_len_w
        + max_lag work samples (the NCCF shifted window), tail dropped.
        """
        from .ops.resample import resampled_length
        nw = resampled_length(n_samples, self.sample_rate, self.work_rate)
        need = self.frame_len_w + self.max_lag
        if nw < need:
            return 0
        return 1 + (nw - need) // self.hop_len_w

    def validate(self) -> "PitchConfig":
        if self.work_rate > self.sample_rate:
            raise ValueError("work_rate must be <= sample_rate")
        if not (0 < self.min_f0 < self.max_f0):
            raise ValueError("need 0 < min_f0 < max_f0")
        if self.max_f0 > self.work_rate / 2:
            raise ValueError("max_f0 must be <= work_rate / 2")
        if self.min_lag >= self.max_lag:
            raise ValueError("empty lag grid (raise work_rate or widen "
                             "the f0 band)")
        if self.norm_window < 1 or self.norm_window % 2 == 0:
            raise ValueError("norm_window must be odd and >= 1")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def config_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def replace(self, **kw) -> "PitchConfig":
        return dataclasses.replace(self, **kw)


# Named presets matching the baseline's five configs (BASELINE.md).
MFCC13 = FeatureConfig().validate()
LOGMEL80 = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True).validate()


def logmel_config(n_mels: int = 80, deltas: bool = True) -> FeatureConfig:
    """Log-mel variant: mel energies + log, DCT skipped (models/logmel.py)."""
    return FeatureConfig(n_mels=n_mels, n_mfcc=n_mels, deltas=deltas).validate()
