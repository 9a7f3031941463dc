"""DFT algorithm dispatch: radix-2 DIT GEMM vs direct GEMM vs oracle.

The dit2 path halves the MACs of the spectral stage and must stay numerically inside the same 1e-4 end-to-end contract.  Also
regression-covers the hop-block tail-truncation bug: input lengths where
the last frame's samples live in a partial hop block (e.g. 15999 @
400/160) used to crash (direct) or silently broadcast a stale block
(dit2).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.ops import framing, spectrum
from mfcc_tpu.models import mfcc as mfcc_model

ATOL = 1e-4
CFG = FeatureConfig()


def test_auto_resolves_to_measured_winner():
    # direct is the default; dit2 variants are opt-in.  Eligibility
    # still gates FORCED dit2 configs.
    assert spectrum.resolve_dft_algorithm(CFG) == "direct"
    assert spectrum.dit_eligible(CFG)


@pytest.mark.parametrize("variant", [
    dict(hop_ms=10.0625),               # hop 161 — odd hop
    dict(n_fft=1024, sample_rate=8000),
    dict(window="hann"),
])
def test_auto_fallback(variant):
    cfg = FeatureConfig(**variant).validate()
    assert spectrum.resolve_dft_algorithm(cfg) == "direct"


def test_forced_dit2_on_ineligible_config_raises():
    with pytest.raises(ValueError):
        FeatureConfig(hop_ms=10.0625, dft_algorithm="dit2").validate()
    with pytest.raises(ValueError):
        FeatureConfig(hop_ms=10.0625, dft_algorithm="dit2c").validate()
    with pytest.raises(ValueError):
        FeatureConfig(dft_algorithm="nope").validate()


def test_forced_dit4c_on_ineligible_config_raises():
    # hop 162: even (dit2-eligible) but not divisible by 4
    cfg2 = FeatureConfig(hop_ms=10.125)
    assert cfg2.dit2_eligible and not cfg2.dit4_eligible
    with pytest.raises(ValueError):
        cfg2.replace(dft_algorithm="dit4c").validate()
    with pytest.raises(ValueError):  # n_fft % 8 != 0
        FeatureConfig(n_fft=516, dft_algorithm="dit4c").validate()


@pytest.mark.parametrize("other", [
    spectrum.power_spectrum_dit_split,
    spectrum.power_spectrum_dit_concat,
    spectrum.power_spectrum_direct_concat,
    spectrum.power_spectrum_dit4_concat,
])
def test_spectrum_parity_vs_direct(rng, other):
    """Raw power spectra agree to f32 roundoff (relative to peak)."""
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    y = framing.preemphasize(jnp.asarray(x), CFG)
    lo_d, hi_d = spectrum.power_spectrum_blocked_split(y, CFG)
    lo_t, hi_t = other(y, CFG)
    peak = float(np.asarray(lo_d).max())
    assert np.asarray(lo_d).shape == np.asarray(lo_t).shape
    assert np.abs(np.asarray(lo_d) - np.asarray(lo_t)).max() < 3e-6 * peak
    assert np.abs(np.asarray(hi_d) - np.asarray(hi_t)).max() < 3e-6 * peak


@pytest.mark.parametrize("algo", ["dit2", "dit2c", "directc", "dit4c"])
@pytest.mark.parametrize("variant", [
    dict(),
    dict(window="povey"),
    dict(window="hann"),
    dict(sample_rate=8000, n_fft=256, n_mels=20),
    dict(n_fft=1024),
    dict(preemph=0.0),
    dict(frame_ms=25.125),              # frame_len 402 — uneven parity split
    dict(frame_ms=25.0625),             # frame_len 401 — odd frame_len
])
def test_dit_end_to_end_vs_oracle(rng, algo, variant):
    cfg = FeatureConfig(dft_algorithm=algo, **variant).validate()
    n = cfg.sample_rate  # 1 s
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    want = oracle.mfcc(x.astype(np.float64), cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("algo", ["direct", "directc", "dit2", "dit2c",
                                  "dit4c"])
@pytest.mark.parametrize("n", [560, 639, 641, 799, 15999, 8081])
def test_awkward_lengths_vs_oracle(rng, algo, n):
    """Lengths whose tail hop block is partial (regression: truncated
    block view crashed direct / silently corrupted dit2 before the
    zero-pad fix in spectrum._block_view)."""
    cfg = FeatureConfig(dft_algorithm=algo)
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    want = oracle.mfcc(x.astype(np.float64), cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_batched_dit_matches_unbatched(rng):
    cfg = FeatureConfig(dft_algorithm="dit2")
    xs = (rng.standard_normal((3, 16000)) * 0.3).astype(np.float32)
    lens = np.full((3,), 16000, np.int32)
    fb, _, _ = mfcc_model.mfcc_batch_jit(jnp.asarray(xs), jnp.asarray(lens),
                                         cfg)
    for i in range(3):
        fi = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(xs[i]), cfg))
        np.testing.assert_allclose(np.asarray(fb[i]), fi, atol=1e-5)
