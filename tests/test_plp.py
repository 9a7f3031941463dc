"""PLP pipeline: oracle parity, stage sanity, batch/ragged, runner/CLI.

Differential pattern as everywhere (SURVEY.md §4): oracle.plp (float64)
is the trust root; the f32 JAX pipeline is pinned to it.  The oracle's
own bark/LPC machinery is sanity-checked against first principles
(filter shapes, AR-model recovery) rather than another library — scipy
has no PLP.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import plp as plp_model
from mfcc_tpu.utils import wav

ATOL = 1e-4
CFG = FeatureConfig().validate()


# ---------------------------------------------------------------- oracle --

def test_bark_filterbank_shape_and_support():
    fb = oracle.bark_filterbank(CFG)
    assert fb.shape == (CFG.n_bark, CFG.n_bins)
    assert np.all(fb >= 0.0)
    # each filter has nonempty support and peaks inside its band
    assert np.all(fb.max(axis=1) > 0.0)
    # centers ascend in frequency
    assert np.all(np.diff(fb.argmax(axis=1)) >= 0)


def test_autocorr_idft_matches_full_idft(rng):
    """r = phi @ A must equal the exact inverse rfft of the even spectrum."""
    M, p = CFG.n_bark + 2, CFG.lpc_order
    phi = np.abs(rng.standard_normal((7, M))) + 0.1
    r = phi @ oracle.autocorr_idft_matrix(M, p)
    # full even extension: [phi[0..M-1], phi[M-2..1]] -> irfft
    want = np.fft.irfft(phi, n=2 * (M - 1), axis=-1)[:, : p + 1]
    np.testing.assert_allclose(r, want, atol=1e-12)


def test_levinson_recovers_ar_model(rng):
    """Autocorrelation of a known AR(2) process -> Levinson must return
    the AR coefficients (theoretical r from the Yule-Walker relations)."""
    a1, a2 = -1.1, 0.4   # stable AR(2): x[n] = -a1 x[n-1] - a2 x[n-2] + w
    # theoretical normalized autocorrelation rho[k]
    rho = np.zeros(6)
    rho[0] = 1.0
    rho[1] = -a1 / (1 + a2)
    for k in range(2, 6):
        rho[k] = -a1 * rho[k - 1] - a2 * rho[k - 2]
    a, e = oracle.levinson_np(rho[None, :], 2)
    np.testing.assert_allclose(a[0], [1.0, a1, a2], atol=1e-12)
    assert 0.0 < e[0] < 1.0


def test_lpc_cepstra_match_log_spectrum(rng):
    """The cepstral recursion must agree with the definitional cepstrum
    of the all-pole model: with log|H(w)|^2 = log e - 2 log|A(w)| =
    2 ln G + sum_m 2 c_m cos(mw), the inverse rfft gives exactly
    cep[0] = log e and cep[m] = c_m (the one-sided complex cepstrum of
    the minimum-phase H — the convention this framework emits)."""
    a = np.array([[1.0, -0.5, 0.25]])
    e = np.array([2.0])
    n = 40
    c = oracle.lpc_to_cepstra_np(a, e, n)
    w = np.fft.rfftfreq(1024) * 2 * np.pi
    A = a[0, 0] + a[0, 1] * np.exp(-1j * w) + a[0, 2] * np.exp(-2j * w)
    logS = np.log(e[0]) - 2.0 * np.log(np.abs(A))
    cep = np.fft.irfft(logS)
    want = np.concatenate([[cep[0]], cep[1: n]])
    np.testing.assert_allclose(c[0], want, atol=1e-10)


# -------------------------------------------------------------- pipeline --

@pytest.mark.parametrize("variant", [
    dict(),
    dict(lpc_order=8),
    dict(n_bark=17, lifter=22),
    dict(sample_rate=8000, n_fft=256, n_bark=15),
    dict(deltas=True),
    dict(append_energy=True),
    dict(dither=1.0 / 32768.0),
])
def test_plp_jax_matches_oracle(rng, variant):
    cfg = FeatureConfig(**variant).validate()
    x = (0.3 * rng.standard_normal(cfg.sample_rate)).astype(np.float32)
    got = np.asarray(plp_model.plp_jit(jnp.asarray(x), cfg))
    want = oracle.plp(x.astype(np.float64), cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plp_speechlike_parity(speechlike):
    got = np.asarray(plp_model.plp_jit(jnp.asarray(speechlike), CFG))
    want = oracle.plp(np.asarray(speechlike, np.float64), CFG)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plp_batch_matches_single_and_masks(rng):
    xs = (0.3 * rng.standard_normal((3, 16000))).astype(np.float32)
    lens = np.array([16000, 9000, 0], np.int32)
    feat, flens, mask = plp_model.plp_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    assert feat.shape[0] == 3 and feat.shape[2] == CFG.n_mfcc
    for i, L in enumerate(lens):
        single = np.asarray(plp_model.plp_jit(jnp.asarray(xs[i][:L]), CFG)) \
            if L else np.zeros((0, CFG.n_mfcc), np.float32)
        T = int(flens[i])
        assert T == single.shape[0]
        np.testing.assert_allclose(np.asarray(feat[i, :T]), single, atol=2e-5)
        assert np.all(np.asarray(feat[i, T:]) == 0.0)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(n_bark=17, lifter=22),
    dict(deltas=True),
    dict(append_energy=True),
])
def test_plp_pallas_backend_matches_oracle_and_xla(rng, variant):
    """The default backend's PLP variants match the float64 oracle
    (contract), and the batch entry equals the single-signal entry."""
    cfg = FeatureConfig(**variant).validate()
    x = (0.3 * rng.standard_normal(cfg.sample_rate)).astype(np.float32)
    got = np.asarray(plp_model.plp_jit(jnp.asarray(x), cfg, "auto"))
    want = oracle.plp(x.astype(np.float64), cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    fb, fl, _ = plp_model.plp_batch_jit(
        jnp.asarray(x)[None], jnp.asarray([x.size], np.int32), cfg)
    # 5e-5: the liftered variants multiply high cepstra by up to ~12,
    # amplifying the two programs' f32 fusion differences
    np.testing.assert_allclose(np.asarray(fb)[0, : int(fl[0])], got,
                               atol=5e-5)


def test_plp_pallas_batch_masks(rng):
    """Ragged PLP batch: each row matches the oracle on its valid frames
    and its padded frames are zero."""
    xs = (0.3 * rng.standard_normal((2, 16000))).astype(np.float32)
    lens = np.array([16000, 9000], np.int32)
    feat, flens, mask = plp_model.plp_batch_jit(
        jnp.asarray(xs), jnp.asarray(lens), CFG)
    feat = np.asarray(feat)
    for i, L in enumerate(lens):
        T = int(flens[i])
        want = oracle.plp(xs[i, :L].astype(np.float64), CFG)
        assert T == want.shape[0]
        np.testing.assert_allclose(feat[i, :T], want, atol=ATOL)
        assert np.all(feat[i, T:] == 0.0)


def test_plp_degenerate_silence():
    """All-zero audio must produce finite features (log-floored), no NaNs."""
    x = jnp.zeros((8000,), jnp.float32)
    got = np.asarray(plp_model.plp_jit(x, CFG))
    assert np.all(np.isfinite(got))


def test_plp_validation():
    with pytest.raises(ValueError):
        FeatureConfig(lpc_order=0).validate()
    with pytest.raises(ValueError):
        FeatureConfig(n_bark=10, lpc_order=12).validate()


# ---------------------------------------------------------------- runner --

def test_runner_plp_end_to_end(tmp_path, rng):
    from mfcc_tpu import runner
    x = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    wav.write_wav(tmp_path / "u.wav", x, 16000)
    out = tmp_path / "feats"
    rep = runner.run(str(tmp_path), CFG, runner.RunnerOptions(
        out_dir=str(out), batch_size=2, plp=True))
    assert rep.n_utterances == 1
    assert rep.max_abs_error is not None and rep.max_abs_error < ATOL
    got = np.load(out / "u.npy")
    xq, _ = wav.read_wav(tmp_path / "u.wav")
    want = oracle.plp(xq.astype(np.float64), CFG)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cli_plp_flag(tmp_path, rng):
    from mfcc_tpu import cli
    x = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    wav.write_wav(tmp_path / "u.wav", x, 16000)
    rc = cli.main([str(tmp_path), "-o", str(tmp_path / "o"), "--plp",
                   "--lifter", "22"])
    assert rc == 0
    assert (tmp_path / "o" / "u.npy").exists()
