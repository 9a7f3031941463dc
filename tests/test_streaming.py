"""Streaming == batch bit-exactness (config 4 contract)."""

import numpy as np
import pytest
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, oracle
from mfcc_tpu.models import streaming, mfcc as mfcc_model

CFG = FeatureConfig()
ATOL = 1e-4


def _stream_all(x, cfg, chunk_frames):
    """Feed x chunk by chunk through process_chunk_jit, collect valid."""
    C = chunk_frames * cfg.hop_len
    n_chunks = len(x) // C
    st = streaming.init_state(cfg)
    out = []
    for k in range(n_chunks):
        st, feat, nv = streaming.process_chunk_jit(
            st, jnp.asarray(x[k * C:(k + 1) * C]), cfg)
        out.append(np.asarray(feat)[: int(nv)])
    return np.concatenate(out), st


def test_streaming_matches_batch(speechlike):
    got, st = _stream_all(speechlike, CFG, chunk_frames=10)
    want = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), CFG))
    # streaming emits only frames fully contained in delivered samples
    assert got.shape[0] == CFG.num_frames(len(speechlike))
    np.testing.assert_allclose(got, want[: got.shape[0]], atol=1e-5)


@pytest.mark.parametrize("algo, tol", [
    ("direct", 1e-5),   # streaming uses the same direct bases: f32 roundoff
    ("directc", 1e-5),
    ("dit2", 3e-5),     # different summation order; measured ~1.2e-5 worst
    ("dit2c", 3e-5),    # case on unit-variance noise (ADVICE r1), bound 3e-5
    ("dit4c", 3e-5),    # two twiddle levels; same f32 error class as dit2
])
def test_streaming_matches_batch_per_algorithm(speechlike, algo, tol):
    """Streaming always runs the direct frames path; the batch side may be
    configured to any factorization.  Pin the measured cross-algorithm
    agreement bound so a future default flip can't silently break the
    streaming contract (ADVICE r1, medium)."""
    cfg = FeatureConfig(dft_algorithm=algo).validate()
    got, _ = _stream_all(speechlike, cfg, chunk_frames=10)
    want = np.asarray(mfcc_model.mfcc_jit(jnp.asarray(speechlike), cfg))
    np.testing.assert_allclose(got, want[: got.shape[0]], atol=tol)


def test_streaming_matches_oracle(speechlike):
    got, _ = _stream_all(speechlike, CFG, chunk_frames=25)
    want = oracle.mfcc(speechlike, CFG)
    np.testing.assert_allclose(got, want[: got.shape[0]], atol=ATOL)


def test_streaming_chunk_size_invariance(speechlike):
    a, _ = _stream_all(speechlike[:16000], CFG, chunk_frames=5)
    b, _ = _stream_all(speechlike[:16000], CFG, chunk_frames=20)
    n = min(a.shape[0], b.shape[0])
    np.testing.assert_allclose(a[:n], b[:n], atol=1e-6)


def test_streaming_first_chunk_partial():
    """First chunks shorter than a frame emit zero valid frames."""
    cfg = CFG
    st = streaming.init_state(cfg)
    chunk = jnp.zeros(cfg.hop_len, jnp.float32)  # 160 samples < 400
    st, feat, nv = streaming.process_chunk_jit(st, chunk, cfg)
    assert int(nv) == 0
    st, feat, nv = streaming.process_chunk_jit(st, chunk, cfg)
    assert int(nv) == 0
    st, feat, nv = streaming.process_chunk_jit(st, chunk, cfg)
    assert int(nv) == 1  # 480 samples -> first 400-sample frame complete


def test_scan_driver_matches_stepwise(speechlike):
    x = speechlike[: 16000 - 16000 % (8 * CFG.hop_len)]
    feats, total = streaming.stream_signal(jnp.asarray(x), CFG, chunk_frames=8)
    stepwise, _ = _stream_all(x, CFG, chunk_frames=8)
    feats = np.asarray(feats)
    # scan output is slot-aligned; compact valid rows = stepwise concat
    assert int(total) == stepwise.shape[0]
    want = oracle.mfcc(x, CFG)[: int(total)]
    # gather the valid slots: they are the first `nv_k` of each chunk's slots,
    # cumulative == frames_done ordering; compare the nonzero rows
    nz = np.where(np.any(feats != 0.0, axis=1))[0]
    np.testing.assert_allclose(feats[nz][: want.shape[0]], want, atol=ATOL)


def test_preemph_continuity_across_chunks(rng):
    """The chunk-boundary predecessor sample must come from the prev chunk."""
    x = rng.standard_normal(8000).astype(np.float32)
    got, _ = _stream_all(x, CFG, chunk_frames=4)
    want = oracle.mfcc(x.astype(np.float64), CFG)
    np.testing.assert_allclose(got, want[: got.shape[0]], atol=ATOL)


def test_batched_streaming_matches_single(rng):
    """B concurrent streams via one vmapped call == per-stream loop."""
    B, n_chunks, cf = 3, 6, 10
    C = cf * CFG.hop_len
    xs = (rng.standard_normal((B, n_chunks * C)) * 0.4).astype(np.float32)
    st = streaming.init_state_batch(B, CFG)
    outs = [[] for _ in range(B)]
    for k in range(n_chunks):
        st, feat, nv = streaming.process_chunk_batch_jit(
            st, jnp.asarray(xs[:, k * C:(k + 1) * C]), CFG)
        feat = np.asarray(feat)
        for b in range(B):
            outs[b].append(feat[b, : int(nv[b])])
    for b in range(B):
        got = np.concatenate(outs[b])
        want, _ = _stream_all(xs[b], CFG, chunk_frames=cf)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_delta_stream_matches_batch(rng):
    """DeltaStream emission == batch append_deltas, for any chunking."""
    from mfcc_tpu import oracle
    from mfcc_tpu.ops.deltas import DeltaStream
    feat = rng.standard_normal((57, 13))
    d1 = oracle.deltas(feat, 2)
    want = np.concatenate([feat, d1, oracle.deltas(d1, 2)], axis=-1)
    for chunks in ([57], [1] * 57, [5, 20, 3, 29], [10, 47]):
        ds = DeltaStream(window=2)
        parts = []
        off = 0
        for c in chunks:
            parts.append(ds.push(feat[off:off + c]))
            off += c
        parts.append(ds.flush())
        got = np.concatenate([p for p in parts if p.size], axis=0)
        np.testing.assert_allclose(got, want, atol=1e-12,
                                   err_msg=f"chunks={chunks}")


def test_delta_stream_long_memory_bounded(rng):
    from mfcc_tpu.ops.deltas import DeltaStream
    ds = DeltaStream(window=2)
    total = 0
    for _ in range(50):
        out = ds.push(rng.standard_normal((20, 13)))
        total += out.shape[0]
    assert ds._buf.shape[0] <= 20 + 8 + 8   # bounded retention
    total += ds.flush().shape[0]
    assert total == 1000


def test_streaming_int16_chunks(rng):
    pcm = (rng.standard_normal(3200) * 8000).astype(np.int16)
    st = streaming.init_state(CFG)
    st, f16, nv = streaming.process_chunk_jit(st, jnp.asarray(pcm), CFG)
    st2 = streaming.init_state(CFG)
    xf = pcm.astype(np.float32) / 32768.0
    st2, ff, nv2 = streaming.process_chunk_jit(st2, jnp.asarray(xf), CFG)
    assert int(nv) == int(nv2)
    np.testing.assert_allclose(np.asarray(f16), np.asarray(ff), atol=1e-6)


def test_multichunk_dispatch_matches_stepwise(speechlike):
    """process_chunks_jit (K chunks per device call) == K sequential
    process_chunk calls, bit-exact."""
    K, CF = 5, 10
    C = CF * CFG.hop_len
    x = speechlike[: K * C]
    chunks = jnp.asarray(x.reshape(K, C))
    st0 = streaming.init_state(CFG)
    st_scan, feats, nvs = streaming.process_chunks_jit(st0, chunks, CFG)
    st = st0
    for k in range(K):
        st, f, nv = streaming.process_chunk_jit(st, chunks[k], CFG)
        np.testing.assert_array_equal(np.asarray(feats[k]), np.asarray(f))
        assert int(nvs[k]) == int(nv)
    np.testing.assert_array_equal(np.asarray(st_scan.carry),
                                  np.asarray(st.carry))
    assert int(st_scan.frames_done) == int(st.frames_done)


def test_multichunk_multisession_dispatch(speechlike):
    """(B sessions x K chunks) per dispatch == per-session scans."""
    B, K, CF = 3, 4, 8
    C = CF * CFG.hop_len
    xs = np.stack([np.roll(speechlike, 100 * b)[: K * C] for b in range(B)])
    chunks = jnp.asarray(xs.reshape(B, K, C))
    st0 = streaming.init_state_batch(B, CFG)
    st, feats, nvs = streaming.process_chunks_batch_jit(st0, chunks, CFG)
    assert feats.shape == (B, K, CF, CFG.n_mfcc)
    for b in range(B):
        _, f1, nv1 = streaming.process_chunks_jit(
            streaming.init_state(CFG), chunks[b], CFG)
        # vmapped GEMMs batch/reassociate differently: f32 noise, not bits
        np.testing.assert_allclose(np.asarray(feats[b]), np.asarray(f1),
                                   atol=1e-5)


def _deslot(feats, nvs):
    """(K, slots, F) scan-path chunk outputs -> contiguous valid frames."""
    return np.concatenate([np.asarray(feats[k])[: int(nvs[k])]
                           for k in range(feats.shape[0])])


def test_fused_serving_dither_position_consistent(speechlike):
    """Dither noise is indexed by ABSOLUTE sample position: B sessions x
    K chunks per dispatch, over two dispatches, reproduce the batch
    pipeline dithering each whole signal."""
    cfg = CFG.replace(dither=1.0 / 32768.0).validate()
    B, K, CF = 2, 3, 8
    C = CF * cfg.hop_len
    xs = np.stack([speechlike[: 2 * K * C],
                   np.roll(speechlike, 777)[: 2 * K * C]])
    st = streaming.init_state_batch(B, cfg)
    got = [[] for _ in range(B)]
    for d in range(2):
        chunks = jnp.asarray(
            xs[:, d * K * C: (d + 1) * K * C].reshape(B, K, C))
        st, feats, nvs = streaming.process_chunks_batch_jit(st, chunks, cfg)
        for b in range(B):
            got[b].append(_deslot(feats[b], nvs[b]))
    want = np.asarray(mfcc_model.mfcc_batch_jit(
        jnp.asarray(xs), jnp.full((B,), xs.shape[1], jnp.int32), cfg)[0])
    for b in range(B):
        g = np.concatenate(got[b])
        np.testing.assert_allclose(g, want[b, : g.shape[0]], atol=1e-5)


@pytest.mark.parametrize("variant", ["mfcc", "logmel", "plp", "spec"])
def test_fused_serving_matches_scan_path(speechlike, variant):
    """The serving step (B sessions x K chunks per dispatch, two
    dispatches for startup shift + carry continuity) emits the batch
    model's frames for every variant; the carry and frame counts equal
    the single-session scan's."""
    from mfcc_tpu.models import logmel as logmel_model
    from mfcc_tpu.models import plp as plp_model
    from mfcc_tpu.models import spectrogram as spec_model
    batch_fn = {"mfcc": mfcc_model.mfcc_batch_jit,
                "logmel": logmel_model.log_mel_batch_jit,
                "plp": plp_model.plp_batch_jit,
                "spec": spec_model.log_spectrogram_batch_jit}[variant]
    B, K, CF = 2, 3, 8
    C = CF * CFG.hop_len
    xs = np.stack([speechlike[: 2 * K * C],
                   np.roll(speechlike, 777)[: 2 * K * C]])
    st = streaming.init_state_batch(B, CFG)
    got = [[] for _ in range(B)]
    for d in range(2):
        chunks = jnp.asarray(
            xs[:, d * K * C: (d + 1) * K * C].reshape(B, K, C))
        st, feats, nvs = streaming.process_chunks_batch_jit(
            st, chunks, CFG, variant)
        for b in range(B):
            got[b].append(_deslot(feats[b], nvs[b]))
            s1, _, _ = streaming.process_chunks_jit(
                streaming.init_state(CFG),
                jnp.asarray(xs[b, : (d + 1) * K * C].reshape(-1, C)), CFG,
                variant)
            np.testing.assert_array_equal(np.asarray(st.carry[b]),
                                          np.asarray(s1.carry))
            assert int(st.frames_done[b]) == int(s1.frames_done)
    want = np.asarray(batch_fn(jnp.asarray(xs),
                               jnp.full((B,), xs.shape[1], jnp.int32),
                               CFG)[0])
    for b in range(B):
        g = np.concatenate(got[b])
        w = want[b, : g.shape[0]]
        if variant == "spec":
            keep = w > (w.max(axis=1, keepdims=True) - np.log(10.0 ** 5))
            assert np.abs((g - w)[keep]).max() < 2e-4
            np.testing.assert_allclose(g, w, atol=1e-2)
        else:
            np.testing.assert_allclose(g, w, atol=2e-5)


def test_fused_serving_rejects_unbounded_logmel(speechlike):
    """The multi-chunk serving step refuses what the single-chunk step
    refuses: unknown variants and chunks that are not hop multiples."""
    B, K, CF = 1, 2, 8
    C = CF * CFG.hop_len
    st = streaming.init_state_batch(B, CFG)
    chunks = jnp.asarray(speechlike[: B * K * C].reshape(B, K, C))
    with pytest.raises(ValueError, match="variant"):
        streaming.process_chunks_batch_jit(st, chunks, CFG, "nope")
    with pytest.raises(ValueError, match="multiple of hop"):
        streaming.process_chunks_batch_jit(st, chunks[..., :-1], CFG)


def test_streaming_logmel_matches_batch(rng):
    """variant='logmel' streams the DCT-skipped pipeline bit-consistently
    with the batch log-mel model's prefix."""
    from mfcc_tpu.models import logmel as logmel_model
    cfg = FeatureConfig(n_mels=40, n_mfcc=40).validate()
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    C = 32 * cfg.hop_len
    xs = x[: (x.size // C) * C]
    st = streaming.init_state(cfg)
    rows = []
    for i in range(xs.size // C):
        st, feat, nv = streaming.process_chunk_jit(
            st, jnp.asarray(xs[i * C: (i + 1) * C]), cfg, "logmel")
        rows.append(np.asarray(feat)[: int(nv)])
    got = np.concatenate(rows)
    want, flens, _ = logmel_model.log_mel_batch_jit(
        jnp.asarray(xs)[None], jnp.asarray([xs.size], np.int32), cfg)
    np.testing.assert_allclose(got, np.asarray(want)[0, : got.shape[0]],
                               atol=1e-5)


def test_streaming_plp_matches_batch(rng):
    """variant='plp' streams bark+LPC cepstra matching the batch PLP
    model's prefix."""
    from mfcc_tpu.models import plp as plp_model
    cfg = FeatureConfig().validate()
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    C = 32 * cfg.hop_len
    xs = x[: (x.size // C) * C]
    st = streaming.init_state(cfg)
    rows = []
    for i in range(xs.size // C):
        st, feat, nv = streaming.process_chunk_jit(
            st, jnp.asarray(xs[i * C: (i + 1) * C]), cfg, "plp")
        rows.append(np.asarray(feat)[: int(nv)])
    got = np.concatenate(rows)
    want, flens, _ = plp_model.plp_batch_jit(
        jnp.asarray(xs)[None], jnp.asarray([xs.size], np.int32), cfg)
    np.testing.assert_allclose(got, np.asarray(want)[0, : got.shape[0]],
                               atol=2e-5)


def test_streaming_spec_matches_batch(rng):
    """variant='spec' streams the floored log power spectrogram matching
    the batch spectrogram model's prefix (same split-bin bases; raw
    single-bin valleys compare under the family's 50 dB window rule,
    docs/conventions.md accuracy policy)."""
    from mfcc_tpu.models import spectrogram as spec_model
    cfg = FeatureConfig().validate()
    x = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    C = 32 * cfg.hop_len
    xs = x[: (x.size // C) * C]
    st = streaming.init_state(cfg)
    rows = []
    for i in range(xs.size // C):
        st, feat, nv = streaming.process_chunk_jit(
            st, jnp.asarray(xs[i * C: (i + 1) * C]), cfg, "spec")
        rows.append(np.asarray(feat)[: int(nv)])
    got = np.concatenate(rows)
    assert got.shape[1] == cfg.n_bins
    want = np.asarray(spec_model.log_spectrogram_batch_jit(
        jnp.asarray(xs)[None], jnp.asarray([xs.size], np.int32), cfg,
        "xla")[0])[0, : got.shape[0]]
    keep = want > (want.max(axis=1, keepdims=True) - np.log(10.0 ** 5))
    assert np.abs((got - want)[keep]).max() < 2e-4
    np.testing.assert_allclose(got, want, atol=1e-2)  # valleys: f32 floor


def test_streaming_bad_variant():
    cfg = FeatureConfig()
    st = streaming.init_state(cfg)
    with pytest.raises(ValueError):
        streaming.process_chunk(st, jnp.zeros((cfg.hop_len,)), cfg, "nope")
