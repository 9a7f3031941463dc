"""The feature path across the config grid: every framing, rate, window,
projection and post-processing variant the pipeline supports, checked
against the float64 oracle on ragged batches, single signals and the
edge cases of the hop-block decomposition."""

import numpy as np
import jax.numpy as jnp
import pytest

from mfcc_tpu import FeatureConfig, backend, oracle
from mfcc_tpu.models import logmel as logmel_model, mfcc as mfcc_model

ATOL = 1e-4
CFG = FeatureConfig()

CONFIGS = [
    dict(),                                   # 400/160 at 16 kHz
    dict(frame_ms=25.0625),                   # frame_len 401: odd tail
    dict(n_fft=1024),
    dict(sample_rate=8000, n_fft=256, n_mels=20),
    dict(sample_rate=8000, n_fft=256),        # telephone speech
    dict(append_energy=True),
    dict(lifter=22),
    dict(dynamic_range_db=80.0),
    dict(preemph=0.0),
    dict(frame_ms=32.0, hop_ms=16.0),         # hop 256
    dict(vtln_warp=1.1),
    dict(sample_rate=48000, n_fft=2048),      # studio rate
    dict(hop_ms=8.25),                        # hop 132
    dict(hop_ms=10.0625),                     # odd hop 161
    dict(sample_rate=22050, n_fft=1024),      # hop 220
    dict(n_mels=80, n_mfcc=80, dynamic_range_db=50.0),
    dict(append_energy=True, lifter=22, deltas=True),
    dict(frame_ms=18.75, hop_ms=8.0),         # frame 300, hop 128
]
IDS = ["-".join(f"{k}={v}" for k, v in kw.items()) or "default"
       for kw in CONFIGS]


def _lift(cfg):
    # liftering scales coefficient i by up to 1 + lifter/2 (~12x at 22),
    # amplifying f32 noise by the same factor: compare unliftered so the
    # 1e-4 contract means the same thing for every variant
    lift = oracle.lifter_coeffs(cfg.n_mfcc, cfg.lifter)
    return np.tile(lift, 3) if cfg.deltas else lift


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_batch_matches_oracle(rng, kw):
    """Ragged batch (full and two-thirds length rows): each row matches
    the oracle on its valid frames; frame counts follow the config."""
    cfg = FeatureConfig(**kw).validate()
    n = cfg.sample_rate
    lens = [n, n - n // 3]
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    x[1, lens[1]:] = 0.0
    feat, fl, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(x), jnp.asarray(lens, np.int32), cfg)
    feat, fl = np.asarray(feat), np.asarray(fl)
    for b, L in enumerate(lens):
        want = oracle.mfcc(x[b, :L].astype(np.float64), cfg)
        assert fl[b] == cfg.num_frames(L) == want.shape[0]
        np.testing.assert_allclose(feat[b, : fl[b]] / _lift(cfg),
                                   want / _lift(cfg), atol=ATOL)
        assert np.all(feat[b, fl[b]:] == 0.0)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_single_matches_batch(rng, kw):
    """The single-signal entry equals the batch entry's row (f32
    fusion noise only)."""
    cfg = FeatureConfig(**kw).validate()
    n = cfg.sample_rate // 2
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    one = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    bat, fl, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(x)[None], jnp.asarray([n], np.int32), cfg)
    assert one.shape[0] == int(fl[0])
    np.testing.assert_allclose(one / _lift(cfg),
                               np.asarray(bat)[0, : one.shape[0]]
                               / _lift(cfg), atol=2e-5)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_logmel_batch_matches_oracle(rng, kw):
    """The log-mel family (DCT skipped) over the same config grid: ragged
    rows vs the oracle on their valid frames, padded frames zero."""
    cfg = FeatureConfig(**{**kw, "n_mfcc": kw.get("n_mels", 26)}).validate()
    n = cfg.sample_rate
    lens = [n, n - n // 3]
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    x[1, lens[1]:] = 0.0
    feat, fl, _ = logmel_model.log_mel_batch_jit(
        jnp.asarray(x), jnp.asarray(lens, np.int32), cfg)
    feat, fl = np.asarray(feat), np.asarray(fl)
    for b, L in enumerate(lens):
        want = oracle.log_mel(x[b, :L].astype(np.float64), cfg)
        assert fl[b] == want.shape[0]
        np.testing.assert_allclose(feat[b, : fl[b]], want, atol=ATOL)
        assert np.all(feat[b, fl[b]:] == 0.0)


@pytest.mark.parametrize("kw, atol", [
    (dict(n_mels=80, n_mfcc=80, dynamic_range_db=50.0), ATOL),
    (dict(n_mels=40, n_mfcc=40, dynamic_range_db=50.0), ATOL),
    (dict(n_mels=40, n_mfcc=40), 2e-4),       # unbounded valleys
    (dict(n_mels=40, n_mfcc=40, append_energy=True), 2e-4),
    (dict(n_mels=40, n_mfcc=40, hop_ms=8.25, append_energy=True), 2e-4),
    (dict(n_mels=40, n_mfcc=40, hop_ms=10.0625, append_energy=True), 2e-4),
], ids=["80-50db", "40-50db", "40", "40-energy", "40-hop132-energy",
        "40-hop161-energy"])
def test_logmel_matches_oracle(rng, kw, atol):
    """Log-mel (DCT skipped) vs the oracle; append_energy never
    substitutes band 0 of a log-mel output."""
    cfg = FeatureConfig(**kw).validate()
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    got = np.asarray(logmel_model.log_mel_jit(jnp.asarray(x), cfg))
    want = oracle.log_mel(x.astype(np.float64), cfg)
    assert got.shape == want.shape == (cfg.num_frames(16000), cfg.n_mels)
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("n", [16000, 15999, 12000, 1601, 401, 400])
def test_hop_block_tail(rng, n):
    """Signal lengths that leave a partial hop block (or exactly one
    frame): the block view pads the tail, so the last frame matches."""
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), CFG))
    want = oracle.mfcc(x.astype(np.float64), CFG)
    assert got.shape == want.shape == (CFG.num_frames(n), CFG.n_mfcc)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("family", ["mfcc", "logmel", "plp", "spec"])
def test_short_signal(family):
    """Shorter than one frame: zero frames, the family's width."""
    from mfcc_tpu.models import plp as plp_model
    from mfcc_tpu.models import spectrogram as spec_model
    fn, width = {"mfcc": (mfcc_model.mfcc_batch_jit, CFG.n_mfcc),
                 "logmel": (logmel_model.log_mel_batch_jit, CFG.n_mels),
                 "plp": (plp_model.plp_batch_jit, CFG.n_mfcc),
                 "spec": (spec_model.log_spectrogram_batch_jit,
                          CFG.n_bins)}[family]
    feat, fl, _ = fn(jnp.zeros((1, 300), jnp.float32),
                     jnp.asarray([300], np.int32), CFG)
    assert feat.shape == (1, 0, width) and int(fl[0]) == 0


def test_multi_batch_long_rows(rng):
    x = (rng.standard_normal((4, 48000)) * 0.3).astype(np.float32)
    feat, fl, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(x), jnp.full((4,), 48000, jnp.int32), CFG)
    assert feat.shape == (4, 298, 13)
    for b in range(4):
        want = oracle.mfcc(x[b].astype(np.float64), CFG)
        np.testing.assert_allclose(np.asarray(feat)[b], want, atol=ATOL)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_matmul_precision_modes(rng, precision):
    """Every matmul_precision value runs; "highest" holds the contract
    (the others are faster modes whose error depends on the device)."""
    cfg = FeatureConfig(matmul_precision=precision).validate()
    x = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    want = oracle.mfcc(x.astype(np.float64), cfg)
    assert got.shape == want.shape and np.isfinite(got).all()
    if precision == "highest":
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_backend_registry():
    """One path: "auto" resolves to "xla"; names outside the registry
    raise instead of falling back."""
    assert backend.BACKENDS == ("auto", "xla")
    assert backend.resolve("auto", CFG) == backend.resolve("xla") == "xla"
    for bad in ("pallas", "triton", "mosaic"):
        with pytest.raises(ValueError):
            backend.resolve(bad, CFG)
    with pytest.raises(ValueError):
        mfcc_model.mfcc_jit(jnp.zeros((800,), jnp.float32), CFG, "pallas")
