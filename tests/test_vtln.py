"""VTLN (vocal-tract-length normalization) — piecewise-linear warp of the
mel filter edges (oracle.vtln_warp_freq).  The warp only reshapes the
constant filterbank matrix, so one oracle function covers every path;
parity is pinned for the single-signal and batch pipelines."""

import numpy as np
import jax.numpy as jnp
import pytest

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import mfcc as mfcc_model

ATOL = 1e-4


def test_warp_identity_at_one():
    cfg = FeatureConfig().validate()
    f = np.linspace(0.0, 8000.0, 257)
    np.testing.assert_array_equal(oracle.vtln_warp_freq(f, cfg), f)
    # and the filterbank is bitwise the unwarped one
    np.testing.assert_array_equal(
        oracle.mel_filterbank(cfg),
        oracle.mel_filterbank(cfg.replace(vtln_warp=1.0)))


def test_validate_rejects_raw_cutoffs_outside_band():
    """Monotonicity needs the RAW cutoffs inside (fmin, fmax), not just
    the warp-scaled knees: vtln_high_hz=8500 > fmax=8000 gives
    scale_right < 0 (a non-monotonic warp) even though the scaled knee
    h = 8500*0.85 = 7225 < 8000 passes the knee check."""
    with pytest.raises(ValueError):
        FeatureConfig(vtln_warp=0.85, vtln_high=8500.0).validate()
    # fmin=110 > vtln_low=100 but the scaled knee 100*1.2=120 > 110 passes
    # the knee check — only the raw-cutoff check catches it
    with pytest.raises(ValueError):
        FeatureConfig(vtln_warp=1.2, fmin=110.0).validate()
    # identity warp doesn't engage the VTLN band checks
    FeatureConfig(vtln_warp=1.0, vtln_high=8500.0).validate()


@pytest.mark.parametrize("warp", [0.8, 0.9, 1.1, 1.25])
def test_warp_function_properties(warp):
    cfg = FeatureConfig(vtln_warp=warp).validate()
    f = np.linspace(0.0, cfg.fmax_hz, 4001)
    w = oracle.vtln_warp_freq(f, cfg)
    # fixes the band edges
    assert w[0] == cfg.fmin and abs(w[-1] - cfg.fmax_hz) < 1e-9
    # strictly monotonic (invertible warp)
    assert np.all(np.diff(w) > 0.0)
    # continuous: no jump exceeds the steepest segment's slope
    l = cfg.vtln_low * max(1.0, warp)
    h = cfg.vtln_high_hz * min(1.0, warp)
    s = 1.0 / warp
    max_slope = max((s * l - cfg.fmin) / (l - cfg.fmin), s,
                    (cfg.fmax_hz - s * h) / (cfg.fmax_hz - h))
    assert np.max(np.diff(w)) <= max_slope * (f[1] - f[0]) + 1e-9
    # mid band scales by exactly 1/warp
    mid = (f >= l) & (f <= h)
    np.testing.assert_allclose(w[mid], f[mid] / warp, rtol=1e-12)


@pytest.mark.parametrize("warp", [0.85, 1.15])
def test_warped_filterbank_valid(warp):
    cfg = FeatureConfig(n_mels=40, vtln_warp=warp).validate()
    fb = oracle.mel_filterbank(cfg)
    assert fb.shape == (40, cfg.n_bins)
    assert np.all(fb >= 0.0)
    # every filter keeps support on the bin grid after warping
    assert np.all(fb.max(axis=1) > 0.0)
    # warping must actually move the response
    fb0 = oracle.mel_filterbank(cfg.replace(vtln_warp=1.0))
    assert np.max(np.abs(fb - fb0)) > 1e-3


def test_vtln_pipeline_parity(speechlike):
    cfg = FeatureConfig(vtln_warp=0.9).validate()
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), cfg))
    want = oracle.mfcc(speechlike, cfg)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vtln_raw_kernel_parity(rng):
    """Ragged VTLN batch vs the oracle on each row's valid frames."""
    cfg = FeatureConfig(vtln_warp=1.1).validate()
    x = (rng.standard_normal((2, 8000)) * 0.3).astype(np.float32)
    x[1, 6000:] = 0.0
    lens = np.asarray([8000, 6000], np.int32)
    feat, fl, _ = mfcc_model.mfcc_batch_jit(jnp.asarray(x),
                                            jnp.asarray(lens), cfg)
    got = [np.asarray(feat)[b, : int(fl[b])] for b in range(2)]
    for b in range(2):
        want = oracle.mfcc(x[b, : lens[b]].astype(np.float64), cfg)
        np.testing.assert_allclose(got[b], want, atol=ATOL)


def test_vtln_validation():
    with pytest.raises(ValueError):
        FeatureConfig(vtln_warp=0.0).validate()
    with pytest.raises(ValueError):
        # knees collapse: vtln_low above vtln_high
        FeatureConfig(vtln_warp=0.9, vtln_low=7800.0).validate()
    with pytest.raises(ValueError):
        # upper knee beyond fmax
        FeatureConfig(vtln_warp=0.9, vtln_high=9000.0).validate()
    # negative vtln_high resolves relative to fmax
    cfg = FeatureConfig(fmax=7000.0, vtln_high=-400.0).validate()
    assert cfg.vtln_high_hz == 6600.0
