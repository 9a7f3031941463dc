"""frame_mode="center" (Kaldi snip_edges=false / librosa centering
interop, VERDICT r4 #4): golden-pinned conventions for both framing
modes, parity across families/backends, and the documented exclusions.
Convention definition: config.py frame_mode field note +
docs/conventions.md framing section."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import mfcc as mfcc_model, streaming
from mfcc_tpu.ops import framing

HERE = os.path.join(os.path.dirname(__file__), "golden")
CFG = FeatureConfig(frame_mode="center").validate()


def test_num_frames_kaldi_formula():
    """T = (n + hop//2) // hop (Kaldi snip_edges=false), except
    sub-half-frame signals emit 0 (documented deviation — the valid-mode
    quarantine class)."""
    cfg = CFG
    assert cfg.center_left_pad == 120 and cfg.center_min_samples == 200
    for n in (200, 399, 400, 16000, 16001, 16080):
        assert cfg.num_frames(n) == (n + 80) // 160, n
    for n in (0, 1, 150, 199):
        assert cfg.num_frames(n) == 0, n
    # valid mode unchanged
    v = FeatureConfig()
    assert v.num_frames(16000) == 98 and v.num_frames(399) == 0


def test_center_reflection_is_kaldi_extract_window():
    """The closed-form index map equals Kaldi's ExtractWindow bounce
    loop (symmetric reflection WITH edge duplication), frame placement
    t*hop + hop//2 - frame_len//2."""
    n = 500
    idx = framing.center_reflect_indices(n, CFG)
    P_l = CFG.center_left_pad

    def kaldi_reflect(s):
        while s < 0 or s >= n:
            s = -s - 1 if s < 0 else 2 * n - 1 - s
        return s

    for p in range(len(idx)):
        assert idx[p] == kaldi_reflect(p - P_l), p
    # frame 0 starts at original sample -P_l; its first sample reflects
    # to x[P_l - 1] (edge-duplicating: ..., x[1], x[0], x[0], x[1], ...)
    assert idx[0] == P_l - 1 and idx[P_l - 1] == 0 and idx[P_l] == 0


def test_oracle_matches_golden_center():
    """Freeze the centered convention (golden-pinned, like every other
    family convention — changing it is a breaking change)."""
    from mfcc_tpu.utils import wav
    x, sr = wav.read_wav(os.path.join(HERE, "speech2s.wav"))
    got = oracle.mfcc(x.astype(np.float64), CFG)
    assert got.shape[0] == (len(x) + 80) // 160
    want = np.load(os.path.join(HERE, "mfcc13_center.npy"))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_jax_pipeline_matches_golden_center():
    from mfcc_tpu.utils import wav
    x, _ = wav.read_wav(os.path.join(HERE, "speech2s.wav"))
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), CFG))
    want = np.load(os.path.join(HERE, "mfcc13_center.npy"))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_center_batch_ragged_parity(rng, backend):
    """Ragged batch: per-row reflection at each row's true end, frame
    counts per the center formula, padded slots zero — through the
    explicit XLA path and the default backend resolution."""
    lens = [20000, 17003, 9500, 200]
    xb = np.zeros((4, 20000), np.float32)
    for i, n in enumerate(lens):
        xb[i, :n] = (rng.standard_normal(n) * 0.3).astype(np.float32)
    feat, flens, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xb), jnp.asarray(lens, np.int32), CFG, backend)
    feat, flens = np.asarray(feat), np.asarray(flens)
    for i, n in enumerate(lens):
        assert flens[i] == CFG.num_frames(n)
        want = oracle.mfcc(xb[i, :n].astype(np.float64), CFG)
        assert np.abs(feat[i, : flens[i]] - want).max() < 1e-4, i
        assert np.all(feat[i, flens[i]:] == 0.0)


def test_center_short_rows_emit_zero_frames(rng):
    """Rows under ceil(frame_len/2) samples: 0 frames, all-zero slots
    (single-bounce reflection construction's documented floor)."""
    xb = np.zeros((2, 1000), np.float32)
    xb[0] = rng.standard_normal(1000) * 0.3
    xb[1, :150] = rng.standard_normal(150) * 0.3
    feat, flens, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xb), jnp.asarray([1000, 150], np.int32), CFG)
    assert int(flens[1]) == 0 and np.all(np.asarray(feat)[1] == 0.0)
    assert int(flens[0]) == CFG.num_frames(1000)


def test_center_families_match_oracle(rng):
    """log-mel / PLP / spectrogram inherit the centered convention
    through the same reflect-pad hook."""
    from mfcc_tpu.models import logmel as logmel_model
    from mfcc_tpu.models import plp as plp_model
    from mfcc_tpu.models import spectrogram as spec_model
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    lm_cfg = FeatureConfig(frame_mode="center", n_mels=40, n_mfcc=40,
                           dynamic_range_db=50.0).validate()
    got = np.asarray(logmel_model.log_mel_jit(jnp.asarray(x), lm_cfg))
    want = oracle.log_mel(x.astype(np.float64), lm_cfg)
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-4
    got = np.asarray(plp_model.plp_jit(jnp.asarray(x), CFG))
    want = oracle.plp(x.astype(np.float64), CFG)
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-4
    got = np.asarray(spec_model.log_spectrogram_jit(jnp.asarray(x), CFG))
    want = oracle.log_spectrogram(x.astype(np.float64), CFG)
    keep = want > (want.max(axis=1, keepdims=True) - np.log(10.0 ** 5))
    assert got.shape == want.shape
    assert np.abs((got - want)[keep]).max() < 2e-4


def test_center_dither_matches_oracle(rng):
    """Dither-then-pad order: reflected samples carry reflected noise,
    bit-consistent with the oracle's identical order."""
    cfg = FeatureConfig(frame_mode="center",
                        dither=1.0 / 32768.0).validate()
    x = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(x), cfg))
    want = oracle.mfcc(x.astype(np.float64), cfg)
    assert np.abs(got - want).max() < 1e-4


def test_center_frames_op(rng):
    """ops/framing.frame resolves center mode statically (frames path)."""
    x = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    fr = np.asarray(framing.frame(jnp.asarray(x), CFG))
    assert fr.shape == (CFG.num_frames(4000), CFG.frame_len)
    want = oracle.frame_signal(x.astype(np.float64), CFG)
    np.testing.assert_allclose(fr, want, atol=1e-6)


def test_streaming_rejects_center():
    """Documented exclusion: the right-edge reflection needs EOS
    lookahead (docs/conventions.md)."""
    st = streaming.init_state(CFG)
    with pytest.raises(ValueError, match="valid"):
        streaming.process_chunk(st, jnp.zeros((CFG.hop_len,)), CFG)
    stb = streaming.init_state_batch(1, CFG)
    with pytest.raises(ValueError, match="valid"):
        streaming.process_chunks_batch_jit(
            stb, jnp.zeros((1, 2, 8 * CFG.hop_len)), CFG)


@pytest.mark.slow
def test_center_with_pitch_append(tmp_path, rng):
    """--frame-mode center --pitch: the pitch track keeps its own valid
    framing and edge-replicates onto the longer centered main track
    (align_pitch); the run report's column-separated errors hold."""
    import json
    from mfcc_tpu import cli
    from mfcc_tpu.utils import wav as wavio
    t = np.arange(32000) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.02 * rng.standard_normal(32000)).astype(np.float32)
    wavio.write_wav(str(tmp_path / "u.wav"), x, 16000)
    out = tmp_path / "out"
    rc = cli.main([str(tmp_path / "u.wav"), "-o", str(out),
                   "--frame-mode", "center", "--pitch"])
    assert rc == 0
    feat = np.load(out / "u.npy")
    assert feat.shape == ((32000 + 80) // 160, 16)
    rep = json.load(open(out / "run_report.0.json"))
    assert rep["max_abs_error"] < 1e-4
    assert rep["max_abs_error_pitch"] < 3e-4


def test_center_validation():
    with pytest.raises(ValueError):
        FeatureConfig(frame_mode="same").validate()
    with pytest.raises(ValueError):   # gapped framing has no centering
        FeatureConfig(frame_mode="center", frame_ms=10.0,
                      hop_ms=25.0).validate()


def test_center_config_hash_differs():
    """frame_mode is part of the numerical contract: the hash names it."""
    assert (FeatureConfig().config_hash()
            != FeatureConfig(frame_mode="center").config_hash())
