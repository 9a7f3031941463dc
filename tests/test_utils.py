"""Host-side utils: bucketing, WAV IO, manifest/resume."""

import os

import numpy as np
import pytest

from mfcc_tpu.utils import batch, wav, manifest
from mfcc_tpu.parallel.cmvn import Stats


def test_bucket_ladder_and_pick():
    ladder = batch.bucket_ladder(16000, 16000 * 30)
    assert ladder[0] == 16000 and ladder[-1] >= 16000 * 30
    assert batch.pick_bucket(1, ladder) == 16000
    assert batch.pick_bucket(16001, ladder) == ladder[1]
    assert batch.pick_bucket(10**9, ladder) == ladder[-1]


def test_make_batches_shapes(rng):
    utts = [(f"u{i}", rng.standard_normal(
        int(rng.integers(8000, 64000))).astype(np.float32))
        for i in range(37)]
    ladder = batch.bucket_ladder(16000, 64000)
    batches = list(batch.make_batches(iter(utts), 8, ladder))
    seen = set()
    for b in batches:
        assert b.audio.shape[0] == 8          # constant batch shape
        assert b.audio.shape[1] in ladder
        for i, uid in enumerate(b.ids):
            seen.add(uid)
            L = b.lengths[i]
            orig = dict(utts)[uid]
            np.testing.assert_array_equal(b.audio[i, :L], orig[:L])
            assert np.all(b.audio[i, L:] == 0)
    assert seen == {u for u, _ in utts}


def test_make_batches_truncates_overlong(rng):
    sig = rng.standard_normal(100_000).astype(np.float32)
    ladder = [16000, 32000]
    (b,) = batch.make_batches(iter([("x", sig)]), 1, ladder)
    assert b.audio.shape[1] == 32000 and b.lengths[0] == 32000


def test_wav_roundtrip_pcm16(tmp_path, rng):
    x = (rng.standard_normal(12345) * 0.2).astype(np.float32)
    p = tmp_path / "a.wav"
    wav.write_wav(p, x, 16000)
    y, sr = wav.read_wav(p)
    assert sr == 16000 and y.shape == x.shape
    # PCM16 quantization error only
    np.testing.assert_allclose(y, x, atol=1.0 / 32768)


def test_wav_rejects_garbage(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"not a wav at all")
    with pytest.raises(wav.WavError):
        wav.read_wav(p)
    p2 = tmp_path / "short.wav"
    p2.write_bytes(b"RI")
    with pytest.raises(wav.WavError):
        wav.read_wav(p2)


def test_wav_float32_format(tmp_path, rng):
    # hand-build an IEEE-float wav
    import struct
    x = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    payload = x.tobytes()
    with open(tmp_path / "f.wav", "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16)
                + struct.pack("<HHIIHH", 3, 1, 16000, 64000, 4, 32))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
    y, sr = wav.read_wav(tmp_path / "f.wav")
    np.testing.assert_allclose(y, x, atol=0)


def test_manifest_resume(tmp_path):
    p = str(tmp_path / "m.json")
    m = manifest.Manifest(p, config_hash="abc")
    m.mark("u1")
    m.mark("u2")
    m.save()
    m2 = manifest.Manifest(p, config_hash="abc")
    assert m2.pending(["u1", "u2", "u3"]) == ["u3"]
    with pytest.raises(ValueError):
        manifest.Manifest(p, config_hash="different")


def test_cmvn_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    st = Stats(jnp.asarray(10.0), jnp.arange(13, dtype=jnp.float32),
               jnp.ones(13))
    p = str(tmp_path / "cmvn.npz")
    manifest.save_cmvn(p, st, "h")
    back = manifest.load_cmvn(p, "h")
    assert float(back.count) == 10.0
    np.testing.assert_allclose(np.asarray(back.sum), np.arange(13))
    with pytest.raises(ValueError):
        manifest.load_cmvn(p, "other")


def test_kaldi_ark_roundtrip(tmp_path, rng):
    from mfcc_tpu.utils import kaldi
    feats = {f"utt{i}": rng.standard_normal(
        (int(rng.integers(5, 50)), 13)).astype(np.float32) for i in range(7)}
    prefix = str(tmp_path / "features")
    kaldi.write_ark_scp(prefix, feats)
    back = kaldi.read_scp(prefix + ".scp")
    assert set(back) == set(feats)
    for uid in feats:
        np.testing.assert_array_equal(back[uid], feats[uid])


def test_tfrecord_roundtrip(tmp_path, rng):
    from mfcc_tpu.utils import tfrecord
    feats = {f"utt{i}": rng.standard_normal(
        (int(rng.integers(5, 40)), 13)).astype(np.float32) for i in range(5)}
    p = str(tmp_path / "f.tfrecord")
    tfrecord.write_tfrecord(p, feats)
    back = tfrecord.read_tfrecord(p)
    assert set(back) == set(feats)
    for uid in feats:
        np.testing.assert_array_equal(back[uid], feats[uid])


def test_tfrecord_crc_detects_corruption(tmp_path, rng):
    from mfcc_tpu.utils import tfrecord
    p = str(tmp_path / "f.tfrecord")
    tfrecord.write_tfrecord(p, {"a": rng.standard_normal(
        (4, 3)).astype(np.float32)})
    blob = bytearray(open(p, "rb").read())
    blob[30] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ValueError):
        tfrecord.read_tfrecord(p)


def test_tfrecord_crc32c_known_vector():
    from mfcc_tpu.utils.tfrecord import crc32c
    # RFC 3720 test vector: 32 bytes of zeros -> 0x8A9136AA
    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c(b"123456789") == 0xE3069283


def test_wav_info_header_only(tmp_path, rng):
    x = (rng.standard_normal(12345) * 0.2).astype(np.float32)
    p = tmp_path / "i.wav"
    wav.write_wav(p, x, 16000)
    n, sr = wav.wav_info(p)
    assert (n, sr) == (12345, 16000)
    with pytest.raises(wav.WavError):
        bad = tmp_path / "bad.wav"
        bad.write_bytes(b"RIFF\0\0\0\0WAVEnope")
        wav.wav_info(bad)
