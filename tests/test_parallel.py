"""Fake-pod tests: sharding + collectives on 8 virtual CPU devices.

The distributed test strategy from SURVEY.md §4: pod behavior (mesh,
NamedSharding, psum CMVN reductions) is validated single-process on
8 host devices — the "fake backend" layer.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import mfcc as mfcc_model
from mfcc_tpu.parallel import mesh as mesh_lib, cmvn, dist

CFG = FeatureConfig()


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def _batch(rng, B=8, L=8000):
    xs = rng.standard_normal((B, L)).astype(np.float32) * 0.3
    lens = rng.integers(L // 2, L, B).astype(np.int32)
    for i, l in enumerate(lens):
        xs[i, l:] = 0
    return xs, lens


def test_data_parallel_mfcc_matches_single_device(rng):
    xs, lens = _batch(rng)
    m = mesh_lib.make_mesh()
    xd = mesh_lib.shard_batch(xs, m)
    ld = mesh_lib.shard_batch(lens, m)
    feat_d, fl_d, mask_d = mfcc_model.mfcc_batch_jit(xd, ld, CFG)
    feat, fl, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    # sharded and unsharded XLA programs fuse/round differently; measured
    # worst-case drift ~1.2e-5 abs (~4e-5 rel) on |feat| up to ~17
    np.testing.assert_allclose(np.asarray(feat_d), np.asarray(feat), atol=3e-5)
    np.testing.assert_array_equal(np.asarray(fl_d), np.asarray(fl))


def test_data_parallel_pallas_kernels_match_single_device(rng):
    """The default routes (MFCC and pitch NCCF+Viterbi) are correct under
    a data-sharded mesh: the multi-device corpus path matches one
    device."""
    from mfcc_tpu.config import PitchConfig
    from mfcc_tpu.models import pitch as pitch_model
    xs, lens = _batch(rng)
    m = mesh_lib.make_mesh()
    xd = mesh_lib.shard_batch(xs, m)
    ld = mesh_lib.shard_batch(lens, m)
    feat_d, fl_d, _ = mfcc_model.mfcc_batch_jit(xd, ld, CFG, "auto")
    feat, fl, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG, "auto")
    np.testing.assert_allclose(np.asarray(feat_d), np.asarray(feat),
                               atol=3e-5)
    np.testing.assert_array_equal(np.asarray(fl_d), np.asarray(fl))
    pcfg = PitchConfig().validate()
    pf_d, pl_d, _ = pitch_model.pitch_batch_jit(xd, ld, pcfg, "auto")
    pf, pl, _ = pitch_model.pitch_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), pcfg, "auto")
    np.testing.assert_allclose(np.asarray(pf_d), np.asarray(pf),
                               atol=3e-4)
    np.testing.assert_array_equal(np.asarray(pl_d), np.asarray(pl))


def test_sharded_output_layout(rng):
    xs, lens = _batch(rng)
    m = mesh_lib.make_mesh()
    xd = mesh_lib.shard_batch(xs, m)
    ld = mesh_lib.shard_batch(lens, m)
    feat_d, _, _ = mfcc_model.mfcc_batch_jit(xd, ld, CFG)
    # output stays batch-sharded: no implicit gather to one device
    shard_shapes = {s.data.shape for s in feat_d.addressable_shards}
    assert all(s[0] == xs.shape[0] // 8 for s in shard_shapes)


def test_cmvn_stats_match_oracle(rng):
    xs, lens = _batch(rng)
    feat, fl, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    stats = jax.jit(cmvn.batch_stats)(feat, mask)
    feats_np = [oracle.mfcc(xs[i, : lens[i]].astype(np.float64), CFG)
                for i in range(len(lens))]
    c, s, sq = oracle.cmvn_stats(feats_np)
    assert int(stats.count) == c
    np.testing.assert_allclose(np.asarray(stats.sum), s, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(stats.sumsq), sq, rtol=1e-4, atol=1e-2)


def test_cmvn_psum_equals_auto_sharded(rng):
    xs, lens = _batch(rng)
    m = mesh_lib.make_mesh()
    feat, fl, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    auto = jax.jit(cmvn.batch_stats)(
        mesh_lib.shard_batch(np.asarray(feat), m),
        mesh_lib.shard_batch(np.asarray(mask), m))
    explicit = cmvn.batch_stats_psum(
        mesh_lib.shard_batch(np.asarray(feat), m),
        mesh_lib.shard_batch(np.asarray(mask), m), m)
    np.testing.assert_allclose(float(auto.count), float(explicit.count))
    np.testing.assert_allclose(np.asarray(auto.sum),
                               np.asarray(explicit.sum), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(auto.sumsq),
                               np.asarray(explicit.sumsq), rtol=1e-5)


def test_cmvn_apply_normalizes(rng):
    xs, lens = _batch(rng, B=16)
    feat, fl, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    stats = cmvn.batch_stats(feat, mask)
    normed = cmvn.apply(feat, stats)
    m = np.asarray(mask)
    sel = np.asarray(normed)[m]
    np.testing.assert_allclose(sel.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(sel.std(axis=0), 1.0, atol=1e-3)


def test_stats_merge_associative(rng):
    a = cmvn.Stats(jnp.asarray(3.0), jnp.ones(13), jnp.ones(13))
    b = cmvn.Stats(jnp.asarray(5.0), 2 * jnp.ones(13), 3 * jnp.ones(13))
    z = cmvn.Stats.zero(13)
    ab = a.merge(b).merge(z)
    assert float(ab.count) == 8.0
    np.testing.assert_allclose(np.asarray(ab.sum), 3.0)


def test_host_shard_partition():
    items = list(range(103))
    shards = [dist.host_shard(items, i, 4) for i in range(4)]
    flat = sorted(x for s in shards for x in s)
    assert flat == items
    assert abs(max(map(len, shards)) - min(map(len, shards))) <= 1


def test_mesh_two_axis():
    m = mesh_lib.make_mesh((4, 2), ("data", "feat"))
    assert m.shape == {"data": 4, "feat": 2}


def test_mesh_keeps_device_order():
    """GPUs of a host are joined all to all: the mesh lays devices out in
    the order given, with no topology reordering."""
    devs = jax.devices()[::-1]
    m = mesh_lib.make_mesh((4, 2), ("data", "feat"), devices=devs)
    assert list(m.devices.reshape(-1)) == devs
    assert list(mesh_lib.make_mesh(devices=devs[:4]).devices) == devs[:4]


def test_mesh_shape_mismatch_raises():
    import pytest
    with pytest.raises(ValueError, match="mesh shape"):
        mesh_lib.make_mesh((3, 2), ("data", "feat"))


def test_dist_initialize_single_process_is_noop(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    dist.initialize()
    dist.initialize(num_processes=1)
    assert calls == []


def test_dist_initialize_forwards_local_device_ids(monkeypatch):
    """One process per GPU: the coordinator, count, id and the GPUs this
    process owns all reach jax.distributed.initialize."""
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    dist.initialize("localhost:12345", 4, 2, local_device_ids=[2])
    assert calls == [dict(coordinator_address="localhost:12345",
                          num_processes=4, process_id=2,
                          local_device_ids=[2])]
