"""End-to-end CLI tests — the framework's outermost surface, exercised the
way the reference exercises its binary (/root/reference/test/run.sh): run
the real entry point on real files, check behavior + outputs differentially
against the oracle."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.utils import wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_corpus(tmp_path, rng, n=5):
    d = tmp_path / "corpus"
    d.mkdir()
    sigs = {}
    for i in range(n):
        x = (rng.standard_normal(int(rng.integers(8000, 24000)))
             * 0.3).astype(np.float32)
        p = d / f"utt{i}.wav"
        wav.write_wav(p, x, 16000)
        # reread: features are computed on the PCM16-quantized signal
        sigs[f"utt{i}"], _ = wav._parse(open(p, "rb").read(), None)
    return d, sigs


def _run_cli(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "mfcc_tpu", *args],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


@pytest.mark.slow
def test_cli_corpus_end_to_end(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--batch-size", "4"], tmp_path)
    assert r.returncode == 0, r.stderr
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        feat = np.load(out / f"{name}.npy")
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        assert feat.shape == want.shape
        np.testing.assert_allclose(feat, want, atol=1e-4)
    rep = json.loads((out / "run_report.0.json").read_text())
    assert rep["n_utterances"] == len(sigs)
    assert rep["config_hash"] == cfg.config_hash()


@pytest.mark.slow
def test_cli_resume_skips_done(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    out = tmp_path / "feats"
    r1 = _run_cli([str(d), "-o", str(out)], tmp_path)
    assert r1.returncode == 0, r1.stderr
    r2 = _run_cli([str(d), "-o", str(out)], tmp_path)
    assert r2.returncode != 0  # nothing left to do -> exit 1 + message
    assert "no utterances" in r2.stderr


@pytest.mark.slow
def test_cli_quarantines_bad_wav(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    (d / "corrupt.wav").write_bytes(b"RIFF....WAVEnope")
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr          # job survives
    assert "quarantine" in r.stdout
    assert not (out / "corrupt.npy").exists()
    assert (out / "utt0.npy").exists()


@pytest.mark.slow
def test_cli_logmel_cmvn(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=4)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--logmel", "--n-mels", "32",
                  "--cmvn"], tmp_path)
    assert r.returncode == 0, r.stderr
    # normalized corpus: frame-weighted mean ~0, std ~1 per dim
    allf = np.concatenate([np.load(out / f"{n}.npy") for n in sigs])
    np.testing.assert_allclose(allf.mean(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(allf.std(axis=0), 1.0, atol=1e-2)
    assert (out / "cmvn.npz").exists()


def test_cli_cmvn_online_with_prior(tmp_path, rng):
    """Two-stage production flow: a --cmvn pass writes cmvn.npz, then a
    --cmvn-online run blends those stats as the prior while each causal
    window is young.  Output is checked against the float64 oracle
    chain; the run report's self-check covers the device path."""
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    out1 = tmp_path / "pass1"
    r = _run_cli([str(d), "-o", str(out1), "--cmvn"], tmp_path)
    assert r.returncode == 0, r.stderr
    out2 = tmp_path / "pass2"
    r = _run_cli([str(d), "-o", str(out2), "--cmvn-online", "40",
                  "--cmvn-online-prior", str(out1 / "cmvn.npz")], tmp_path)
    assert r.returncode == 0, r.stderr
    z = np.load(out1 / "cmvn.npz")
    prior = (float(z["count"]), z["sum"].astype(np.float64),
             z["sumsq"].astype(np.float64))
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        feat = np.load(out2 / f"{name}.npy")
        want = oracle.online_cmvn(
            oracle.mfcc(sig.astype(np.float64), cfg), 40, prior=prior)
        np.testing.assert_allclose(feat, want, atol=2e-5)
    rep = json.loads((out2 / "run_report.0.json").read_text())
    assert rep["max_abs_error"] < 1e-4


def test_cli_dynamic_range_db(tmp_path, rng):
    """--dynamic-range-db reaches the pipeline: log-mel output matches
    the oracle with the same per-frame relative floor, and differs from
    the unfloored run in valley bins."""
    d = tmp_path / "corpus"
    d.mkdir()
    # two-tone signal with deep spectral valleys
    t = np.arange(16000) / 16000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 1e-4 * np.sin(2 * np.pi * 3700 * t)).astype(np.float32)
    wav.write_wav(d / "u.wav", x, 16000)
    sig, _ = wav._parse(open(d / "u.wav", "rb").read(), None)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--logmel", "--n-mels", "40",
                  "--dynamic-range-db", "60"], tmp_path)
    assert r.returncode == 0, r.stderr
    cfg = FeatureConfig(n_mels=40, n_mfcc=40, dynamic_range_db=60.0)
    feat = np.load(out / "u.npy")
    want = oracle.log_mel(sig.astype(np.float64), cfg)
    np.testing.assert_allclose(feat, want, atol=1e-4)
    nofloor = oracle.log_mel(sig.astype(np.float64),
                             FeatureConfig(n_mels=40, n_mfcc=40))
    assert np.abs(want - nofloor).max() > 1.0   # the floor engaged


@pytest.mark.slow
def test_cli_vad_column(tmp_path, rng):
    """--vad appends a trailing 0/1 column = oracle.energy_vad on the
    frame log energies (margin-clear tone/silence signal, so the f32
    threshold decisions cannot flip); silence frames are unvoiced."""
    d = tmp_path / "corpus"
    d.mkdir()
    t = np.arange(32000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.02 * rng.standard_normal(32000)).astype(np.float32)
    x[16000:] *= 1e-3                      # second half ~silence
    wav.write_wav(d / "u.wav", x, 16000)
    sig, _ = wav._parse(open(d / "u.wav", "rb").read(), None)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--vad", "--vad-context", "2"],
                 tmp_path)
    assert r.returncode == 0, r.stderr
    cfg = FeatureConfig()
    feat = np.load(out / "u.npy")
    assert feat.shape[1] == cfg.n_mfcc + 1
    want_feat = oracle.mfcc(sig.astype(np.float64), cfg)
    np.testing.assert_allclose(feat[:, :-1], want_feat, atol=1e-4)
    frames = oracle.frame_signal(sig.astype(np.float64), cfg)
    want_vad = oracle.energy_vad(oracle.log_energy(frames, cfg), context=2)
    np.testing.assert_array_equal(feat[:, -1], want_vad.astype(np.float64))
    assert feat[:20, -1].all() and not feat[-20:, -1].any()
    rep = json.loads((out / "run_report.0.json").read_text())
    assert rep["max_abs_error"] < 1e-4    # vad column excluded from it


@pytest.mark.slow
def test_cli_frame_mode_center(tmp_path, rng):
    """--frame-mode center end-to-end: Kaldi snip_edges=false frame
    count, oracle parity via the run report self-check."""
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--frame-mode", "center"],
                 tmp_path)
    assert r.returncode == 0, r.stderr
    cfg = FeatureConfig(frame_mode="center").validate()
    for name, sig in sigs.items():
        feat = np.load(out / f"{name}.npy")
        assert feat.shape[0] == (len(sig) + 80) // 160   # Kaldi count
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        np.testing.assert_allclose(feat, want, atol=1e-4)
    rep = json.loads((out / "run_report.0.json").read_text())
    assert rep["max_abs_error"] < 1e-4
    assert rep["config_hash"] == cfg.config_hash()


def test_cli_vad_cmvn_exclusive(tmp_path):
    r = _run_cli([str(tmp_path), "-o", str(tmp_path / "o"),
                  "--vad", "--cmvn"], tmp_path)
    assert r.returncode != 0
    assert "incompatible" in r.stderr


def test_cli_bad_args():
    r = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu", "nonexistent_dir_xyz",
         "--window", "blackman"],
        capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
        timeout=120)
    assert r.returncode == 2  # argparse rejects the choice


@pytest.mark.slow
def test_cli_ark_format(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=3)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--format", "ark"], tmp_path)
    assert r.returncode == 0, r.stderr
    from mfcc_tpu.utils import kaldi
    back = kaldi.read_scp(str(out / "features.0.scp"))
    assert set(back) == set(sigs)
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        np.testing.assert_allclose(back[name], want, atol=1e-4)


@pytest.mark.slow
def test_cli_tfrecord_format(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--format", "tfrecord"], tmp_path)
    assert r.returncode == 0, r.stderr
    from mfcc_tpu.utils import tfrecord
    back = tfrecord.read_tfrecord(str(out / "features.0.tfrecord"))
    assert set(back) == set(sigs)
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        np.testing.assert_allclose(back[name], want, atol=1e-4)


@pytest.mark.slow
def test_cli_data_parallel_8_devices(tmp_path, rng):
    """Runner shards batches over all local devices (fake 8-CPU pod in
    the child via XLA_FLAGS)."""
    d, sigs = _mk_corpus(tmp_path, rng, n=8)
    out = tmp_path / "feats"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "mfcc_tpu", str(d), "-o", str(out),
         "--batch-size", "8"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    rep = json.loads((out / "run_report.0.json").read_text())
    assert rep["n_devices"] == 8
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        feat = np.load(out / f"{name}.npy")
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        np.testing.assert_allclose(feat, want, atol=1e-4)


@pytest.mark.slow
def test_cli_htk_format(tmp_path, rng):
    d, sigs = _mk_corpus(tmp_path, rng, n=2)
    out = tmp_path / "feats"
    r = _run_cli([str(d), "-o", str(out), "--format", "htk"], tmp_path)
    assert r.returncode == 0, r.stderr
    from mfcc_tpu.utils import htk
    cfg = FeatureConfig()
    for name, sig in sigs.items():
        feat, period, kind = htk.read_htk(str(out / f"{name}.htk"))
        assert abs(period - 0.010) < 1e-9
        assert kind == htk.PARM_USER
        want = oracle.mfcc(sig.astype(np.float64), cfg)
        np.testing.assert_allclose(feat, want, atol=1e-4)
