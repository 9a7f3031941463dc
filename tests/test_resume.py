"""Interrupt-and-resume correctness for the corpus runner (VERDICT r1 #3).

For every writer format x CMVN on/off: run a corpus, kill the run midway
(a writer raises after K utterances — the same state a SIGKILL leaves,
since writers flush before the manifest marks anything), resume, and
assert the outputs equal an uninterrupted run into a fresh directory.

Also covers: the CMVN accumulator checkpoint riding atomically with the
manifest, apply-once semantics on re-run, the corpus-grew-after-apply
guard, and TFRecord tail-record repair after a crash mid-append.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mfcc_tpu import FeatureConfig, runner
from mfcc_tpu.utils import (htk, kaldi, manifest as manifest_lib, tfrecord,
                            wav)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Boom(RuntimeError):
    pass


def _mk_corpus(tmp_path, rng, n=20):
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n):
        x = (rng.standard_normal(int(rng.integers(8000, 16000)))
             * 0.3).astype(np.float32)
        wav.write_wav(d / f"utt{i}.wav", x, 16000)
    return str(d)


def _read_outputs(out_dir: str, fmt: str) -> dict[str, np.ndarray]:
    if fmt == "npy":
        return {f[:-4]: np.load(os.path.join(out_dir, f))
                for f in os.listdir(out_dir) if f.endswith(".npy")}
    if fmt == "ark":
        return kaldi.read_scp(os.path.join(out_dir, "features.0.scp"))
    if fmt == "htk":
        return {f[:-4]: htk.read_htk(os.path.join(out_dir, f))[0]
                for f in os.listdir(out_dir) if f.endswith(".htk")}
    return tfrecord.read_tfrecord(
        os.path.join(out_dir, "features.0.tfrecord"))


def _interrupt_after(monkeypatch, cls, k: int):
    """Make cls.write raise after k successful utterance writes."""
    orig = cls.write
    calls = {"n": 0}

    def bomb(self, uid, feat):
        if calls["n"] >= k:
            raise _Boom()
        calls["n"] += 1
        return orig(self, uid, feat)

    monkeypatch.setattr(cls, "write", bomb)
    return lambda: monkeypatch.setattr(cls, "write", orig)


_WRITERS = {"npy": runner.NpyWriter, "ark": runner.ArkWriter,
            "htk": runner.HTKWriter, "tfrecord": runner.TFRecordWriter}


@pytest.mark.slow
@pytest.mark.parametrize("fmt", ["npy", "ark", "htk", "tfrecord"])
@pytest.mark.parametrize("cmvn", [False, True])
def test_interrupt_resume_equals_uninterrupted(tmp_path, rng, monkeypatch,
                                               fmt, cmvn):
    corpus = _mk_corpus(tmp_path, rng)
    cfg = FeatureConfig(cmvn=cmvn).validate()

    # reference: one uninterrupted run
    ref_dir = str(tmp_path / "ref")
    runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=ref_dir, batch_size=2, out_format=fmt))
    want = _read_outputs(ref_dir, fmt)
    assert len(want) == 20

    # interrupted run: writer dies after 3 utterances
    out_dir = str(tmp_path / "out")
    restore = _interrupt_after(monkeypatch, _WRITERS[fmt], 10)
    with pytest.raises(_Boom):
        runner.run(corpus, cfg, runner.RunnerOptions(
            out_dir=out_dir, batch_size=2, out_format=fmt))
    restore()

    man = manifest_lib.Manifest(
        os.path.join(out_dir, "manifest.0.json"), cfg.config_hash())
    assert 0 < len(man.done) < 20         # genuinely mid-run
    if cmvn and man.done:
        assert man.cmvn is not None       # accumulator checkpointed
        assert not man.cmvn_applied

    # resume
    rep = runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=out_dir, batch_size=2, out_format=fmt))
    got = _read_outputs(out_dir, fmt)
    assert sorted(got) == sorted(want)
    for uid in want:
        if cmvn:
            # resumed stat accumulation rebatches the remainder, so f32
            # summation order differs by design: allow ~ulp-level drift
            np.testing.assert_allclose(got[uid], want[uid],
                                       atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[uid], want[uid])
    assert rep.n_utterances < 20          # only the remainder was recomputed

    # idempotent re-run: nothing pending, apply-once
    rep2 = runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=out_dir, batch_size=2, out_format=fmt))
    assert rep2.n_utterances == 0
    got2 = _read_outputs(out_dir, fmt)
    for uid in want:
        np.testing.assert_array_equal(got2[uid], got[uid])


@pytest.mark.slow
@pytest.mark.slow
def test_interrupt_resume_with_pitch_appended(tmp_path, rng, monkeypatch):
    """--pitch + resume: the appended 3-dim pitch columns survive an
    interrupt/resume cycle bit-identically (the post-processing chain
    runs inside the batch step, so resumed utterances recompute the
    FULL feature row, never a partial one)."""
    # n/k sized for the fake pod: batch_size rounds UP to the 8 local
    # devices, so the bomb must outlive one full 8-utterance batch
    corpus = _mk_corpus(tmp_path, rng, n=16)
    cfg = FeatureConfig().validate()
    opts = dict(batch_size=2, pitch=True)

    ref_dir = str(tmp_path / "ref")
    runner.run(corpus, cfg, runner.RunnerOptions(out_dir=ref_dir, **opts))
    want = _read_outputs(ref_dir, "npy")
    assert len(want) == 16
    assert next(iter(want.values())).shape[1] == cfg.n_mfcc + 3

    out_dir = str(tmp_path / "out")
    restore = _interrupt_after(monkeypatch, _WRITERS["npy"], 10)
    with pytest.raises(_Boom):
        runner.run(corpus, cfg, runner.RunnerOptions(out_dir=out_dir,
                                                     **opts))
    restore()
    man = manifest_lib.Manifest(
        os.path.join(out_dir, "manifest.0.json"), cfg.config_hash())
    assert 0 < len(man.done) < 16
    runner.run(corpus, cfg, runner.RunnerOptions(out_dir=out_dir, **opts))
    got = _read_outputs(out_dir, "npy")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.slow
@pytest.mark.parametrize("fmt", ["npy", "tfrecord"])
def test_sigkill_worker_resume_equals_uninterrupted(tmp_path, rng, fmt):
    """REAL failure injection (VERDICT r4 #3): SIGKILL an actual worker
    process mid-run — the kill lands at an arbitrary instruction, not at
    a cooperative raise — then resume and assert outputs equal an
    uninterrupted run.  Durability contract under test: features are
    flushed before the manifest marks them, the manifest + CMVN
    accumulator commit in one atomic replace (so a kill mid-save leaves
    the previous consistent state), and TFRecord tail repair compacts a
    torn append."""
    n = 48
    corpus = _mk_corpus(tmp_path, rng, n=n)
    cfg = FeatureConfig(cmvn=True).validate()

    ref_dir = str(tmp_path / "ref")
    runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=ref_dir, batch_size=2, out_format=fmt))
    want = _read_outputs(ref_dir, fmt)
    assert len(want) == n

    out_dir = str(tmp_path / "out")
    code = (
        "from mfcc_tpu import FeatureConfig, runner; "
        f"runner.run({corpus!r}, FeatureConfig(cmvn=True).validate(), "
        f"runner.RunnerOptions(out_dir={out_dir!r}, batch_size=2, "
        f"out_format={fmt!r}))")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # poll the manifest; SIGKILL the worker once >= 6 utterances are
    # durable (exact PID of the process we spawned — never by pattern)
    man_path = os.path.join(out_dir, "manifest.0.json")
    deadline = time.time() + 300
    killed = False
    while time.time() < deadline and proc.poll() is None:
        try:
            with open(man_path) as f:
                if len(json.load(f).get("done", [])) >= 6:
                    proc.kill()
                    killed = True
                    break
        except (OSError, ValueError):
            pass  # not written yet / torn read of the tmp rename window
        time.sleep(0.005)
    out = proc.communicate(timeout=60)[0]
    assert killed, f"worker finished before the kill landed:\n{out[-2000:]}"
    assert proc.returncode == -9

    man = manifest_lib.Manifest(man_path, cfg.config_hash())
    assert 0 < len(man.done) < n          # genuinely mid-run
    assert man.cmvn is not None and not man.cmvn_applied

    # resume (fresh process state is irrelevant — in-process is the same
    # code path) and compare to the uninterrupted reference
    rep = runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=out_dir, batch_size=2, out_format=fmt))
    got = _read_outputs(out_dir, fmt)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_allclose(got[uid], want[uid],
                                   atol=1e-5, rtol=1e-5)
    assert rep.n_utterances < n           # only the remainder recomputed


def test_cmvn_applied_guard_on_grown_corpus(tmp_path, rng):
    corpus = _mk_corpus(tmp_path, rng, n=3)
    cfg = FeatureConfig(cmvn=True).validate()
    out_dir = str(tmp_path / "out")
    runner.run(corpus, cfg, runner.RunnerOptions(
        out_dir=out_dir, batch_size=2))
    # corpus grows after normalization was applied
    x = (rng.standard_normal(9000) * 0.3).astype(np.float32)
    wav.write_wav(os.path.join(corpus, "uttZ.wav"), x, 16000)
    with pytest.raises(RuntimeError, match="CMVN was already applied"):
        runner.run(corpus, cfg, runner.RunnerOptions(
            out_dir=out_dir, batch_size=2))


def test_tfrecord_tail_repair(tmp_path, rng):
    path = str(tmp_path / "x.tfrecord")
    feats = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((5, 3)).astype(np.float32)}
    tfrecord.write_tfrecord(path, feats)
    good = os.path.getsize(path)
    with open(path, "ab") as f:       # simulate a crash mid-append
        f.write(b"\x99" * 17)
    assert tfrecord.truncate_incomplete_tail(path) == 17
    assert os.path.getsize(path) == good
    out = tfrecord.read_tfrecord(path)
    np.testing.assert_array_equal(out["a"], feats["a"])
    np.testing.assert_array_equal(out["b"], feats["b"])
    assert tfrecord.truncate_incomplete_tail(path) == 0


def test_ark_append_then_rewrite_atomic(tmp_path, rng):
    prefix = str(tmp_path / "features.0")
    a = rng.standard_normal((4, 13)).astype(np.float32)
    b = rng.standard_normal((6, 13)).astype(np.float32)
    with open(prefix + ".ark", "ab") as ark, open(prefix + ".scp", "a") as scp:
        kaldi.append_ark_entry(ark, scp, prefix + ".ark", "a", a)
        kaldi.append_ark_entry(ark, scp, prefix + ".ark", "b", b)
    got = kaldi.read_scp(prefix + ".scp")
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], b)
    kaldi.write_ark_scp(prefix, {"a": a * 2, "b": b * 2}, atomic=True)
    got = kaldi.read_scp(prefix + ".scp")
    np.testing.assert_array_equal(got["a"], a * 2)
    assert not os.path.exists(prefix + ".ark.tmp")
