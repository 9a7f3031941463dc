"""The one-hot "last valid frame" picks are exact under any default matmul
precision: each contraction is pinned to HIGHEST, so a GPU running float32
dots in TF32 by default still picks the frame bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfcc_tpu.models import pitch as pitch_model
from mfcc_tpu.ops import deltas as deltas_op, post

HIGHEST = jax.lax.Precision.HIGHEST


def _deltas(feat, flens):
    return deltas_op.deltas(feat, 2, flens)


def _splice(feat, flens):
    return post.splice(feat, flens, 2, 2)


def _align(feat, flens):
    return pitch_model.align_pitch(feat, flens, feat.shape[1] + 3)


PICKS = {"deltas": _deltas, "splice": _splice, "align_pitch": _align}


def _inputs(rng):
    # values with a full 24-bit mantissa: a TF32 pick would round them
    feat = (1.0 + rng.random((3, 20, 5)) * 1e-3).astype(np.float32) * 37.0
    flens = np.asarray([20, 13, 1], np.int32)
    return jnp.asarray(feat), jnp.asarray(flens)


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("name", list(PICKS))
def test_pick_pinned_to_highest(rng, name):
    feat, flens = _inputs(rng)
    with jax.default_matmul_precision("tensorfloat32"):
        jaxpr = jax.make_jaxpr(PICKS[name])(feat, flens).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs, "expected the one-hot pick to be a dot_general"
    for p in precs:
        assert p == (HIGHEST, HIGHEST), p
    # the same values as under "highest" everywhere
    with jax.default_matmul_precision("tensorfloat32"):
        tf32 = np.asarray(jax.jit(PICKS[name])(feat, flens))
    with jax.default_matmul_precision("highest"):
        full = np.asarray(jax.jit(PICKS[name])(feat, flens))
    np.testing.assert_array_equal(tf32, full)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PICKS))
def test_pick_exact_on_gpu_under_tf32(rng, gpu, name):
    feat, flens = _inputs(rng)
    fd, ld = jax.device_put(feat, gpu), jax.device_put(flens, gpu)
    with jax.default_matmul_precision("tensorfloat32"):
        got = np.asarray(jax.jit(PICKS[name])(fd, ld))
    cpu = jax.devices("cpu")[0]
    want = np.asarray(jax.jit(PICKS[name])(jax.device_put(feat, cpu),
                                           jax.device_put(flens, cpu)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
