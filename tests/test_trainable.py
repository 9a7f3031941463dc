"""Trainable front-end: init == classic pipeline, training reduces loss."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig
from mfcc_tpu.models import trainable, mfcc as mfcc_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# tiny config keeps CPU compiles fast
CFG = FeatureConfig(sample_rate=2000, frame_ms=25, hop_ms=10, n_fft=64,
                    n_mels=8, n_mfcc=4).validate()


def _data(rng, B=4, N=2000):
    audio = (rng.standard_normal((B, N)) * 0.3).astype(np.float32)
    lens = np.full((B,), N, np.int32)
    return audio, lens


def test_forward_at_init_matches_classic(rng):
    audio, lens = _data(rng)
    params = trainable.init_params(CFG)
    got = np.asarray(trainable.forward(params, jnp.asarray(audio), CFG))
    want, _, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(audio), jnp.asarray(lens), CFG)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_training_recovers_perturbed_filterbank(rng):
    """Well-posed recovery objective: the target comes from the same model
    with a perturbed filterbank, so the optimum is reachable and the
    landscape benign.  (Distilling to a config with floor-saturated log
    values is deliberately NOT tested: 1/E curvature there is unbounded —
    a property of the objective, not the framework.)"""
    audio, lens = _data(rng)
    tgt_params = trainable.init_params(CFG)
    tgt_params = tgt_params._replace(mel_w=tgt_params.mel_w * 1.5)
    target = trainable.forward(tgt_params, jnp.asarray(audio), CFG)
    params, losses = trainable.fit(
        audio, np.asarray(target), CFG, steps=200, lr=3e-3)
    assert losses[-1] < 0.1 * losses[0], losses[::50]
    assert np.all(np.isfinite(np.asarray(params.mel_w)))


def test_gradients_nonzero(rng):
    audio, lens = _data(rng, B=2)
    params = trainable.init_params(CFG)
    target = jnp.zeros((2, CFG.num_frames(2000), CFG.n_mfcc), jnp.float32)
    grads = jax.grad(trainable.loss_fn)(params, jnp.asarray(audio),
                                        target, CFG)
    assert float(jnp.abs(grads.mel_w).max()) > 0


def test_graft_entry_single_chip():
    import sys
    sys.path.insert(0, REPO)
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == args[0].shape[0]
    assert np.all(np.isfinite(np.asarray(out)))


def test_checkpoint_roundtrip(tmp_path, rng):
    import pytest
    params = trainable.init_params(CFG)
    params = params._replace(mel_w=params.mel_w * 1.23)
    p = str(tmp_path / "frontend.npz")
    trainable.save_params(p, params, CFG)
    back = trainable.load_params(p, CFG)
    np.testing.assert_allclose(np.asarray(back.mel_w),
                               np.asarray(params.mel_w))
    with pytest.raises(ValueError):
        trainable.load_params(p, CFG.replace(n_mels=16, n_mfcc=8))
