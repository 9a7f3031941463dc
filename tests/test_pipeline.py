"""Differential tests: JAX pipeline vs the float64 oracle, atol 1e-4.

The analog of the reference's behavior-level differential harness
(/root/reference/test/run.sh — compiled output vs expected exit status):
every stage and the end-to-end pipeline are compared numerically against
the independent float64 implementation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import mfcc as mfcc_model, logmel as logmel_model
from mfcc_tpu.ops import framing, spectrum, mel, dct, deltas as deltas_op

ATOL = 1e-4
CFG = FeatureConfig()


def test_frame_stage_parity(speechlike):
    got = np.asarray(framing.frame(jnp.asarray(speechlike), CFG))
    want = oracle.frame_signal(speechlike, CFG)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_power_stage_parity(speechlike):
    frames64 = oracle.frame_signal(speechlike, CFG)
    got = np.asarray(spectrum.power_spectrum(
        jnp.asarray(frames64, jnp.float32), CFG))
    want = oracle.power_spectrum(frames64, CFG)
    # power values span ~[0, 1e4]; relative tolerance is the right check here
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_logmel_stage_parity(speechlike):
    frames64 = oracle.frame_signal(speechlike, CFG)
    # isolate the stage: feed oracle the same f32-rounded input
    power32 = oracle.power_spectrum(frames64, CFG).astype(np.float32)
    got = np.asarray(mel.log_mel_energies(jnp.asarray(power32), CFG))
    want = oracle.log_mel_energies(power32.astype(np.float64), CFG)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dct_stage_parity(speechlike):
    frames64 = oracle.frame_signal(speechlike, CFG)
    lm64 = oracle.log_mel_energies(oracle.power_spectrum(frames64, CFG), CFG)
    got = np.asarray(dct.cepstra(jnp.asarray(lm64, jnp.float32), CFG))
    want = oracle.cepstra(lm64, CFG)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_end_to_end_parity(speechlike):
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), CFG))
    want = oracle.mfcc(speechlike, CFG)
    assert got.shape == want.shape == (98, 13)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("variant", [
    dict(lifter=22),
    dict(append_energy=True),
    dict(deltas=True),
    dict(window="povey"),
    dict(window="hann"),
    dict(preemph=0.0),
    dict(mel_scale="slaney"),
    dict(n_mels=80, n_mfcc=80),
    dict(n_mels=40, n_mfcc=20, fmin=20.0, fmax=7600.0),
])
def test_end_to_end_parity_variants(speechlike, variant):
    cfg = FeatureConfig(**variant).validate()
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), cfg))
    want = oracle.mfcc(speechlike, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_logmel_end_to_end_parity(speechlike):
    """Narrow 80-mel filters isolate near-cancelled spectral valleys where
    unbounded-range log parity is limited by f32 itself: the error is
    ~2*eps_f32*sqrt(P_peak/P_valley), crossing 1e-4 at valleys ~54 dB
    below the frame peak (see BASELINE.md accuracy note).  The strict
    1e-4 contract applies under a dynamic-range floor (next test); the
    unbounded definition is checked at a conservative 1e-3."""
    cfg = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True).validate()
    got = np.asarray(logmel_model.log_mel_jit(jnp.asarray(speechlike), cfg))
    want = oracle.log_mel(speechlike, cfg)
    assert got.shape == want.shape == (98, 240)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_logmel_end_to_end_parity_floored(speechlike):
    """With a 50 dB dynamic-range floor the strict contract holds
    (floor > the ~54 dB point where f32 valley error crosses 1e-4)."""
    cfg = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True,
                        dynamic_range_db=50.0).validate()
    got = np.asarray(logmel_model.log_mel_jit(jnp.asarray(speechlike), cfg))
    want = oracle.log_mel(speechlike, cfg)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _ragged_batch(rng, lens, pad):
    xs = np.zeros((len(lens), pad), np.float32)
    sigs = []
    for i, L in enumerate(lens):
        s = (0.5 * rng.standard_normal(L)).astype(np.float32)
        xs[i, :L] = s
        sigs.append(s)
    return xs, sigs


def test_batched_ragged_parity(rng):
    lens = [16000, 12345, 8000, 399]  # last one too short -> 0 frames
    xs, sigs = _ragged_batch(rng, lens, 16000)
    feat, flens, mask = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    feat = np.asarray(feat)
    flens = np.asarray(flens)
    mask = np.asarray(mask)
    for i, sig in enumerate(sigs):
        want = oracle.mfcc(sig, CFG)
        assert flens[i] == want.shape[0]
        np.testing.assert_allclose(feat[i, :flens[i]], want, atol=ATOL)
        # padded region exactly zero
        assert np.all(feat[i, flens[i]:] == 0.0)
        assert mask[i].sum() == flens[i]


def test_batched_ragged_deltas_edge_correct(rng):
    """Deltas at the ragged edge must replicate the last REAL frame."""
    cfg = CFG.replace(deltas=True)
    lens = [16000, 9000]
    xs, sigs = _ragged_batch(rng, lens, 16000)
    feat, flens, _ = mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), cfg)
    feat = np.asarray(feat)
    for i, sig in enumerate(sigs):
        want = oracle.mfcc(sig, cfg)
        np.testing.assert_allclose(feat[i, :want.shape[0]], want, atol=ATOL)


def test_deltas_op_matches_oracle(rng):
    f = rng.standard_normal((30, 13)).astype(np.float32)
    got = np.asarray(deltas_op.deltas(jnp.asarray(f), 2))
    want = oracle.deltas(f.astype(np.float64), 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_short_signal_zero_frames():
    x = jnp.zeros(100, jnp.float32)
    feat = mfcc_model.mfcc_jit(x, CFG)
    assert feat.shape == (0, 13)


def test_dynamic_range_floor_parity(speechlike):
    """Kaldi-style relative floor: identical in oracle and pipeline."""
    cfg = FeatureConfig(n_mels=80, n_mfcc=80,
                        dynamic_range_db=60.0).validate()
    got = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), cfg))
    want = oracle.mfcc(speechlike, cfg)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # floored variant actually differs from the unfloored one somewhere
    plain = oracle.mfcc(speechlike, cfg.replace(dynamic_range_db=None))
    assert not np.allclose(want, plain, atol=1e-6)


def test_split_bin_spectrum_parity(speechlike):
    """power_spectrum_blocked_split + log_mel_energies_split must equal
    the concat path exactly (lane-exact DFT optimization)."""
    y = framing.preemphasize(jnp.asarray(speechlike), CFG)
    p = np.asarray(spectrum.power_spectrum_blocked(y, CFG))
    p_lo, p_hi = spectrum.power_spectrum_blocked_split(y, CFG)
    np.testing.assert_allclose(np.asarray(p_lo), p[..., :-1], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(p_hi), p[..., -1:], rtol=0,
                               atol=1e-5)
    lm = np.asarray(mel.log_mel_energies(jnp.asarray(p), CFG))
    lm2 = np.asarray(mel.log_mel_energies_split(p_lo, p_hi, CFG))
    np.testing.assert_allclose(lm2, lm, rtol=0, atol=1e-5)


def test_spectrogram_matches_oracle(speechlike):
    from mfcc_tpu.models import spectrogram
    got = np.asarray(spectrogram.log_spectrogram_jit(
        jnp.asarray(speechlike), CFG))
    want = oracle.log_spectrogram(speechlike, CFG)
    assert got.shape == want.shape == (98, 257)
    # raw single-bin valleys reach -90+ dB where f32 log parity is
    # physically ~1e-2 (2*eps*sqrt(P_peak/P_valley)); the contract is
    # strict 1e-4 within 50 dB of the frame peak, loose beyond
    np.testing.assert_allclose(got, want, atol=5e-2)
    keep = want > (want.max(axis=1, keepdims=True) - np.log(10 ** 5))
    assert np.abs(got[keep] - want[keep]).max() < 1e-4


def test_spectrogram_pallas_backend(speechlike):
    """backend='auto': same windowed contract vs the oracle, and the
    same bins as the explicit XLA path inside the 50 dB window."""
    from mfcc_tpu.models import spectrogram
    got = np.asarray(spectrogram.log_spectrogram_jit(
        jnp.asarray(speechlike), CFG, "auto"))
    want = oracle.log_spectrogram(speechlike, CFG)
    assert got.shape == want.shape == (98, 257)
    np.testing.assert_allclose(got, want, atol=5e-2)
    keep = want > (want.max(axis=1, keepdims=True) - np.log(10 ** 5))
    assert np.abs(got[keep] - want[keep]).max() < 1e-4
    xla = np.asarray(spectrogram.log_spectrogram_jit(
        jnp.asarray(speechlike), CFG, "xla"))
    # each path is within 1e-4 of the oracle in-window (the contract);
    # their mutual distance can reach the 2x triangle bound
    assert np.abs(got[keep] - xla[keep]).max() < 2e-4


def test_cli_spectrogram_flag(tmp_path, rng):
    """--spectrogram end-to-end: (T, 257) outputs, self-check vs the
    oracle twin in the run report, mutual exclusion with --logmel."""
    from mfcc_tpu import cli
    from mfcc_tpu.utils import wav
    x = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    wav.write_wav(tmp_path / "u.wav", x, 16000)
    rc = cli.main([str(tmp_path), "-o", str(tmp_path / "o"),
                   "--spectrogram"])
    assert rc == 0
    feat = np.load(tmp_path / "o" / "u.npy")
    assert feat.shape[1] == CFG.n_bins
    # oracle on the DECODED audio (the WAV roundtrip quantizes to int16,
    # which shifts spectral valleys by far more than the f32 contract)
    xd, _sr = wav.read_wav(tmp_path / "u.wav")
    want = oracle.log_spectrogram(xd.astype(np.float64), CFG)
    keep = want > (want.max(axis=1, keepdims=True) - np.log(10 ** 5))
    assert np.abs(feat[: want.shape[0]][keep] - want[keep]).max() < 2e-4
    with pytest.raises(SystemExit):
        cli.main([str(tmp_path), "-o", str(tmp_path / "o2"),
                  "--spectrogram", "--logmel"])


def test_spectrogram_pallas_batch_masks(rng):
    """Ragged spectrogram batch: the family's 50 dB-window contract
    (2e-4, models/spectrogram docstring) on every row's valid frames,
    zeros past each row's end."""
    from mfcc_tpu.models import spectrogram
    xs = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    lens = np.array([16000, 8000], np.int32)
    feat, flens, _ = spectrogram.log_spectrogram_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG, "auto")
    for b in range(2):
        want = oracle.log_spectrogram(
            xs[b][: lens[b]].astype(np.float64), CFG)
        got = np.asarray(feat[b])[: int(flens[b])]
        keep = want > (want.max(axis=1, keepdims=True) - np.log(10 ** 5))
        assert np.abs(got[keep] - want[keep]).max() < 2e-4
        assert np.all(np.asarray(feat[b])[int(flens[b]):] == 0.0)
