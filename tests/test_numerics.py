"""dtype policy, int16 ingestion, and sanitizer-analog runs
(SURVEY.md §5: debug-NaN + disable-jit equivalence are the project's
race-detector/sanitizer substitutes)."""

import numpy as np
import jax
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import mfcc as mfcc_model

CFG = FeatureConfig()


def test_int16_input_matches_float(rng):
    pcm = (rng.standard_normal((2, 8000)) * 8000).astype(np.int16)
    lens = np.full((2,), 8000, np.int32)
    fi, _, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(pcm), jnp.asarray(lens), CFG)
    xf = pcm.astype(np.float32) / 32768.0
    ff, _, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xf), jnp.asarray(lens), CFG)
    np.testing.assert_allclose(np.asarray(fi), np.asarray(ff), rtol=0,
                               atol=1e-5)


def test_bfloat16_compute_mode(rng):
    """bf16 DFT inputs: fast mode for NN-training features.  Accuracy is
    relaxed (~bf16 resolution through the log), shapes/finiteness hold."""
    cfg = CFG.replace(compute_dtype="bfloat16")
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    want = oracle.mfcc(x.astype(np.float64), CFG)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    # bf16 keeps coarse agreement (log compresses the 2^-8 relative noise).
    # Max error is seed-sensitive (~0.13 for direct AND dit2 on some
    # seeds); gate on a robust bulk metric plus a loose max.
    err = np.abs(got - want)
    assert err.mean() < 0.05
    assert err.max() < 0.3


def test_debug_nans_clean(rng):
    """Pipeline raises nothing under jax_debug_nans, including the log
    floor path on all-zero audio."""
    x = np.zeros((1, 8000), np.float32)
    x2 = (rng.standard_normal((1, 8000)) * 0.3).astype(np.float32)
    lens = np.full((1,), 8000, np.int32)
    with jax.debug_nans(True):
        for xi in (x, x2):
            f, _, _ = mfcc_model.mfcc_batch_jit(
                jnp.asarray(xi), jnp.asarray(lens), CFG)
            assert np.all(np.isfinite(np.asarray(f)))


def test_disable_jit_equivalence(rng):
    x = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    with_jit = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), CFG))
    with jax.disable_jit():
        eager = np.asarray(mfcc_model.mfcc(jnp.asarray(x), CFG))
    np.testing.assert_allclose(with_jit, eager, atol=1e-5)


def test_zero_audio_hits_floor_exactly():
    x = jnp.zeros(8000, jnp.float32)
    feat = np.asarray(mfcc_model.mfcc_jit(x, CFG))
    # log-mel of silence = log(floor) everywhere -> DCT row 0 known value
    lm = np.full((1, CFG.n_mels), np.log(CFG.log_floor))
    want = oracle.cepstra(lm, CFG)[0]
    np.testing.assert_allclose(
        feat, np.tile(want, (feat.shape[0], 1)), rtol=0, atol=1e-4)
