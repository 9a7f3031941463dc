"""Packed ragged batches (VERDICT r4 #1): multiple utterances per padded
row recover the (1 - fill) utilization a bucketed ragged corpus leaves on
the floor.  The load-bearing claim is BIT-IDENTITY: a packed segment's
features equal the standalone computation of that utterance exactly
(hop-aligned placement -> same samples, same GEMM reductions; the
packer's one-sample gap carries the HTK pre-emphasis predecessor)."""

import numpy as np
import pytest
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig
from mfcc_tpu.models import mfcc as mfcc_model
from mfcc_tpu.utils import batch as batch_lib

CFG = FeatureConfig()
HOP = CFG.hop_len


def _ragged(rng, n_utts=12, lo=8000, hi=16000):
    return [(f"u{i}", (rng.standard_normal(int(rng.integers(lo, hi)))
                       * 0.3).astype(np.float32)) for i in range(n_utts)]


def test_pack_rows_geometry(rng):
    sigs = dict(_ragged(rng))
    infos = [(k, len(v)) for k, v in sigs.items()]
    rows = list(batch_lib.pack_rows(infos, capacity=40 * HOP * 25,
                                    hop=HOP, lookahead=8))
    seen = []
    for row in rows:
        prev_end = None
        for uid, off, n in row.segments:
            assert off % HOP == 0                       # frame grid
            if prev_end is not None:
                assert off >= prev_end + 1              # predecessor gap
            assert off + n <= row.capacity
            prev_end = off + n
            seen.append(uid)
    assert sorted(seen) == sorted(sigs)                 # exactly once


def test_pack_improves_fill(rng):
    """Steady-state fill beats the one-utterance-per-row baseline on the
    benchmark's own distribution (uniform n/2..n -> 75% mean fill)."""
    n = 160000
    lens = np.linspace(n // 2, n, 64).astype(int)
    infos = [(i, int(L)) for i, L in enumerate(lens)]
    C = 8 * n
    rows = list(batch_lib.pack_rows(infos, capacity=C, hop=HOP,
                                    lookahead=64))
    full = rows[:-1] or rows                # steady-state rows
    fill = sum(s[2] for r in full for s in r.segments) / (len(full) * C)
    assert fill > 0.90, fill


def _standalone(family):
    from mfcc_tpu.models import logmel as logmel_model
    return {"mfcc": mfcc_model.mfcc_batch_jit,
            "logmel": logmel_model.log_mel_batch_jit}[family]


@pytest.mark.parametrize("family", ["mfcc", "logmel"])
def test_packed_features_bit_identical(rng, family):
    """Segment features == standalone features, bitwise (same reduction
    per output element); gap/boundary frames zeroed."""
    sigs = _ragged(rng, n_utts=6)
    infos = [(k, len(v)) for k, v in sigs]
    by_id = dict(sigs)
    C = 5 * 16000
    rows = list(batch_lib.pack_rows(infos, capacity=C, hop=HOP,
                                    lookahead=16))
    S = max(len(r.segments) for r in rows)
    B = len(rows)
    x = np.zeros((B, C), np.float32)
    starts = np.zeros((B, S), np.int32)
    lens = np.zeros((B, S), np.int32)
    for b, row in enumerate(rows):
        sig, st, ln = batch_lib.pack_audio(row, by_id.__getitem__)
        x[b] = sig
        starts[b, : len(st)], lens[b, : len(ln)] = st, ln
    feat, f0, fc, mask = mfcc_model.mfcc_batch_packed_jit(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens), CFG,
        family=family)
    feat = np.asarray(feat)
    f0, fc, mask = np.asarray(f0), np.asarray(fc), np.asarray(mask)
    for b, row in enumerate(rows):
        for j, (uid, off, n) in enumerate(row.segments):
            want, wl, _ = _standalone(family)(
                jnp.asarray(by_id[uid][None, :n]),
                jnp.asarray([n], np.int32), CFG)
            assert fc[b, j] == int(wl[0]) == CFG.num_frames(n)
            got = feat[b, f0[b, j]: f0[b, j] + fc[b, j]]
            np.testing.assert_array_equal(got, np.asarray(want)[0])
    # everything outside the union of segments is zero
    assert np.all(feat[~mask] == 0.0)


@pytest.mark.parametrize("family", ["mfcc", "logmel"])
def test_split_packed_features_bit_identical(rng, family):
    """Splittable packing: utterances split across rows at frame
    boundaries (streaming-chunk construction) reassemble to the
    standalone features EXACTLY — including continuations whose
    pre-emphasis predecessor is the true preceding sample."""
    sigs = _ragged(rng, n_utts=7, lo=9000, hi=30000)
    by_id = dict(sigs)
    infos = [(k, len(v)) for k, v in sigs]
    C = 2 * 16000
    rows = list(batch_lib.pack_rows_split(infos, capacity=C, hop=HOP,
                                          frame_len=CFG.frame_len))
    # rows fill to ~capacity (splitting makes next-fit near-perfect)
    for r in rows[:-1]:
        last = r.segments[-1]
        assert last.row_off + last.span > C - CFG.frame_len - HOP
    S = max(len(r.segments) for r in rows)
    B = len(rows)
    x = np.zeros((B, C), np.float32)
    starts = np.zeros((B, S), np.int32)
    lens = np.zeros((B, S), np.int32)
    pieces = []
    for b, row in enumerate(rows):
        sig, st, ln, pcs = batch_lib.pack_audio_split(
            row, by_id.__getitem__)
        x[b] = sig
        starts[b, : len(st)], lens[b, : len(ln)] = st, ln
        pieces.append(pcs)
    feat, f0, fc, mask = mfcc_model.mfcc_batch_packed_jit(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens), CFG,
        family=family)
    feat = np.asarray(feat)
    # reassemble per utterance and compare bitwise to standalone
    n_out = CFG.n_mfcc if family == "mfcc" else CFG.n_mels
    rebuilt = {k: np.zeros((CFG.num_frames(len(v)), n_out),
                           np.float32) for k, v in sigs}
    covered = {k: np.zeros((CFG.num_frames(len(v)),), bool) for k, v in sigs}
    for b, pcs in enumerate(pieces):
        for j, pc in enumerate(pcs):
            rows_out = feat[b, int(f0[b, j]): int(f0[b, j] + fc[b, j])]
            assert int(fc[b, j]) == pc.n_frames
            rebuilt[pc.uid][pc.frame_start: pc.frame_start
                            + pc.n_frames] = rows_out
            covered[pc.uid][pc.frame_start: pc.frame_start
                            + pc.n_frames] = True
    for uid, sig in sigs:
        assert covered[uid].all()
        want, wl, _ = _standalone(family)(
            jnp.asarray(sig[None]), jnp.asarray([len(sig)], np.int32), CFG)
        np.testing.assert_array_equal(rebuilt[uid],
                                      np.asarray(want)[0, : int(wl[0])])


@pytest.mark.slow
@pytest.mark.parametrize("cmvn", [False, True])
def test_runner_pack_end_to_end(tmp_path, rng, cmvn):
    """--pack through the production runner: outputs equal the unpacked
    run bit-for-bit (no cmvn) / to stats roundoff (cmvn); resume works;
    corrupt + short files handled."""
    import os
    from mfcc_tpu import runner, FeatureConfig
    from mfcc_tpu.utils import wav
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(9):
        x = (rng.standard_normal(int(rng.integers(6000, 30000)))
             * 0.3).astype(np.float32)
        wav.write_wav(d / f"u{i}.wav", x, 16000)
    wav.write_wav(d / "tiny.wav",
                  np.zeros(100, np.float32), 16000)   # < one frame
    (d / "bad.wav").write_bytes(b"RIFFxxxxWAVEjunk")
    cfg = FeatureConfig(cmvn=cmvn).validate()

    ref = str(tmp_path / "ref")
    runner.run(str(d), cfg, runner.RunnerOptions(out_dir=ref,
                                                 batch_size=4))
    out = str(tmp_path / "out")
    rep = runner.run(str(d), cfg, runner.RunnerOptions(
        out_dir=out, batch_size=4, pack=True, pack_seconds=2.5))
    assert rep.n_utterances == 10       # 9 + tiny; bad quarantined
    if not cmvn:
        assert rep.max_abs_error is not None and rep.max_abs_error < 1e-4
    for i in range(9):
        want = np.load(os.path.join(ref, f"u{i}.npy"))
        got = np.load(os.path.join(out, f"u{i}.npy"))
        # 2e-5: the fake 8-device pod shards both runs' batches, and
        # different row widths partition the GEMMs differently (the
        # dryrun's sharded-vs-unsharded tolerance class); UNSHARDED
        # packed-vs-standalone is bitwise — test_*_bit_identical above
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   rtol=1e-5 if cmvn else 0)
    assert np.load(os.path.join(out, "tiny.npy")).shape[0] == 0
    assert not os.path.exists(os.path.join(out, "bad.npy"))
    # resume: nothing pending
    rep2 = runner.run(str(d), cfg, runner.RunnerOptions(
        out_dir=out, batch_size=4, pack=True, pack_seconds=2.5))
    assert rep2.n_utterances == 0


@pytest.mark.slow
@pytest.mark.parametrize("flag, tol", [("plp", 2e-5), ("spectrogram", 2e-4)])
def test_runner_pack_plp_spectrogram(tmp_path, rng, flag, tol):
    """--pack extends to the PLP and spectrogram families (frame-local
    back halves): packed outputs equal the unpacked runner's at the
    fake-pod sharding tolerance (spectrogram under the family's 50 dB
    window rule)."""
    import os
    from mfcc_tpu import runner, FeatureConfig
    from mfcc_tpu.utils import wav
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(5):
        x = (rng.standard_normal(int(rng.integers(9000, 26000)))
             * 0.3).astype(np.float32)
        wav.write_wav(d / f"u{i}.wav", x, 16000)
    cfg = FeatureConfig().validate()
    kw = {flag: True}
    ref = str(tmp_path / "ref")
    runner.run(str(d), cfg, runner.RunnerOptions(out_dir=ref,
                                                 batch_size=4, **kw))
    out = str(tmp_path / "out")
    rep = runner.run(str(d), cfg, runner.RunnerOptions(
        out_dir=out, batch_size=4, pack=True, pack_seconds=2.0, **kw))
    assert rep.n_utterances == 5
    for i in range(5):
        want = np.load(os.path.join(ref, f"u{i}.npy"))
        got = np.load(os.path.join(out, f"u{i}.npy"))
        assert got.shape == want.shape
        if flag == "spectrogram":
            keep = want > (want.max(axis=1, keepdims=True)
                           - np.log(10.0 ** 5))
            assert np.abs((got - want)[keep]).max() < tol
        else:
            np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.slow
def test_runner_pack_many_tiny_utterances(tmp_path, rng):
    """Stress the per-row segment bound: a corpus of near-minimal
    (1-3 frame) utterances packs at the worst-case piece density."""
    import os
    from mfcc_tpu import runner, FeatureConfig
    from mfcc_tpu.utils import wav
    d = tmp_path / "corpus"
    d.mkdir()
    n = 60
    for i in range(n):
        L = int(rng.integers(400, 500))
        x = (rng.standard_normal(L) * 0.3).astype(np.float32)
        wav.write_wav(d / f"t{i:03d}.wav", x, 16000)
    cfg = FeatureConfig().validate()
    out = str(tmp_path / "out")
    rep = runner.run(str(d), cfg, runner.RunnerOptions(
        out_dir=out, batch_size=2, pack=True, pack_seconds=1.0))
    assert rep.n_utterances == n
    files = [f for f in os.listdir(out) if f.endswith(".npy")]
    assert len(files) == n


def test_runner_pack_guards(tmp_path):
    from mfcc_tpu import runner, FeatureConfig
    with pytest.raises(ValueError, match="pack"):
        runner.run(str(tmp_path), FeatureConfig().validate(),
                   runner.RunnerOptions(out_dir=str(tmp_path / "o"),
                                        pack=True, pitch=True))


@pytest.mark.parametrize("row_frames", [128, 511])
def test_mfcc_long_bit_identical(rng, row_frames):
    """mfcc_long (blocked single-stream front end) == mfcc, bitwise:
    overlapping hop-aligned rows, dropped context slot, true
    pre-emphasis predecessors, reassembly by reshape."""
    x = (rng.standard_normal(7 * 16000 + 1234) * 0.3).astype(np.float32)
    want = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), CFG))
    got = np.asarray(mfcc_model.mfcc_long_jit(jnp.asarray(x), CFG,
                                              "auto", row_frames))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # deltas applied after reassembly (exact), dither positions match
    cfg_d = CFG.replace(deltas=True, dither=1.0 / 32768.0).validate()
    want = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg_d))
    got = np.asarray(mfcc_model.mfcc_long_jit(jnp.asarray(x), cfg_d,
                                              "auto", row_frames))
    np.testing.assert_array_equal(got, want)
    # short-signal fallback hits the plain path
    xs = x[:8000]
    np.testing.assert_array_equal(
        np.asarray(mfcc_model.mfcc_long_jit(jnp.asarray(xs), CFG,
                                            "auto", row_frames)),
        np.asarray(mfcc_model.mfcc_jit(jnp.asarray(xs), CFG)))


def test_mfcc_auto_routes_long_single(rng, monkeypatch):
    """mfcc() keeps long single signals on the plain hop-block path:
    the blocked row construction runs only when mfcc_long is called."""
    called = {}
    orig = mfcc_model._blocked_from_audio

    def spy(*a, **k):
        called["routed"] = True
        return orig(*a, **k)

    monkeypatch.setattr(mfcc_model, "_blocked_from_audio", spy)
    x = (rng.standard_normal(60 * 16000) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc(jnp.asarray(x), CFG))
    assert not called
    want = np.asarray(mfcc_model.mfcc_long(jnp.asarray(x), CFG))
    assert called.get("routed")
    np.testing.assert_array_equal(got, want)


def test_mfcc_long_center_mode(rng):
    """Center framing resolves before row-blocking (exact)."""
    cfg = FeatureConfig(frame_mode="center").validate()
    x = (rng.standard_normal(5 * 16000) * 0.3).astype(np.float32)
    want = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    got = np.asarray(mfcc_model.mfcc_long_jit(jnp.asarray(x), cfg,
                                              "auto", 128))
    np.testing.assert_array_equal(got, want)


def test_packed_rejects_deltas_and_center():
    x = jnp.zeros((1, 16000))
    s = jnp.zeros((1, 1), jnp.int32)
    l = jnp.full((1, 1), 16000, jnp.int32)
    with pytest.raises(ValueError, match="deltas"):
        mfcc_model.mfcc_batch_packed(x, s, l,
                                     FeatureConfig(deltas=True))
    with pytest.raises(ValueError, match="valid"):
        mfcc_model.mfcc_batch_packed(x, s, l,
                                     FeatureConfig(frame_mode="center"))
