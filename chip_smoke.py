"""GPU smoke test: the corpus MFCC path and the library paths on the card.

    python chip_smoke.py          # one GPU: phases 1-3
    python chip_smoke.py --four   # four GPUs: phase 1 and the sharded
                                  # corpus run with its comparison only

Phases (any failure raises and exits non-zero; nothing is caught):

1. device   — JAX must find a GPU; prints the card's name and power limit
              (nvidia-smi), the JAX version and the compile-cache dir.
2. corpus   — 256 seeded speech-like PCM16 WAVs (2-20 s) through the CLI
              with global CMVN, padded bucket ladder, then with --pack.
              Raw features (recovered from the normalized output with the
              run's own float64 statistics) vs oracle.mfcc at 1e-4; the
              CMVN output vs a float64 CMVN of the oracle features.
3. library  — mfcc_batch_jit (64, 10 s); log-mel-80 + deltas at the 50 dB
              window; streaming (16 sessions x 100 ms chunks) vs batch;
              pitch (64, 10 s) with resample / NCCF / Viterbi timed apart;
              the MFCC error at matmul_precision "high" and "default".
              Timed inputs rotate through more bytes than the 50 MB L2.

No hand-written kernel is in the tree, so there is no kernel A/B phase
(docs/kernels.md has the last one).

The last stdout line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig, cli, oracle
from mfcc_tpu.config import PitchConfig
from mfcc_tpu.models import logmel as logmel_model, mfcc as mfcc_model
from mfcc_tpu.models import pitch as pitch_model, streaming
from mfcc_tpu.ops import pitch as pitch_op
from mfcc_tpu.ops.resample import resample
from mfcc_tpu.utils import compile_cache, wav

SEED = 0
# Tolerances (max abs vs the float64 oracle unless stated).  Precision:
# every spectral GEMM runs at Precision.HIGHEST, IEEE float32 on the GPU.
MFCC_ATOL = 1e-4          # MFCC-13 contract
CMVN_ATOL = 1e-4          # normalized features vs float64 CMVN of oracle
# log-mel-80 + deltas at dynamic_range_db = 50: 1e-4 on the contract's
# pinned signals (tests/test_accuracy_floor.py); 2.5e-4 — the f32 model
# bound of the next window class — on the 10 s speech-like batch, whose
# harmonic valleys measure above 1e-4 on the CPU backend as well.
LOGMEL_ATOL = 1e-4
LOGMEL_WIDE_ATOL = 2.5e-4
STREAM_ATOL = 1e-5        # streaming vs batch (tests/test_streaming.py)
# pitch [pov, normalized log pitch, delta] on the pinned signals of
# tests/test_pitch.py; on long signals f32-vs-f64 Viterbi ties can move
# the path, so the timed batch is checked for shape and finiteness only.
PITCH_ATOL = (1e-4, 3e-4, 1e-4)
L2_BYTES = 50 * 2 ** 20   # H100 L2: timed inputs rotate through more


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def speechlike(rng, n: int, sr: int = 16000) -> np.ndarray:
    """Harmonic voice with a gliding f0, syllabic envelope and noise."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220) * (1.0 + 0.2 * np.sin(
        2 * np.pi * rng.uniform(0.5, 3.0) * t + rng.uniform(0, 6.28)))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum((0.5 / k) * np.sin(k * ph) for k in range(1, 7))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sig * env + 0.02 * rng.standard_normal(n)
    return (0.7 * sig / np.max(np.abs(sig))).astype(np.float32)


def timed(fn, inputs, reps: int):
    """Median seconds per call, rotating through ``inputs``."""
    jax.block_until_ready(fn(*inputs[0]))
    ts = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*inputs[r % len(inputs)]))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def rotated(rng, B: int, n: int):
    """Enough distinct (audio, lengths) batches to exceed the L2 cache."""
    k = max(2, -(-2 * L2_BYTES // (B * n * 4)))
    base = np.stack([speechlike(rng, n) for _ in range(B)])
    out = []
    for i in range(k):
        a = np.roll(base, 997 * i, axis=1)
        out.append((jnp.asarray(a), jnp.asarray(np.full((B,), n, np.int32))))
    return base, out


# ---------------------------------------------------------------- phase 1

def phase_device(want_count: int):
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {d.platform!r} devices")
    if len(jax.local_devices()) < want_count:
        raise SystemExit(f"need {want_count} GPUs, found "
                         f"{len(jax.local_devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    cache = compile_cache.enable()
    log("device", platform=d.platform, kind=repr(d.device_kind),
        count=len(devs), jax=jax.__version__, cache_dir=cache)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------- phase 2

def write_corpus(root: str, n_utts: int = 256):
    rng = np.random.default_rng(SEED)
    paths = []
    for i in range(n_utts):
        n = int(rng.uniform(2.0, 20.0) * 16000)
        p = os.path.join(root, f"utt{i:04d}.wav")
        wav.write_wav(p, speechlike(rng, n), 16000)
        paths.append(p)
    return paths


def oracle_corpus(paths, cfg):
    want = {}
    for p in paths:
        x, _ = wav.read_wav(p)      # the PCM16-quantized samples
        want[p] = oracle.mfcc(x.astype(np.float64), cfg)
    return want


def check_corpus_run(tag, corpus, out, want, args):
    t0 = time.perf_counter()
    rc = cli.main([corpus, "-o", out, "--cmvn", "--no-resume", *args])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{tag}: CLI exited {rc}")
    with open(os.path.join(out, "run_report.0.json")) as f:
        rep = json.load(f)
    if rep["n_utterances"] != len(want):
        raise RuntimeError(f"{tag}: {rep['n_utterances']} utterances "
                           f"written, {len(want)} expected")
    z = np.load(os.path.join(out, "cmvn.npz"))
    c = float(z["count"])
    mean = z["sum"] / c
    std = np.sqrt(np.maximum(z["sumsq"] / c - mean * mean, 1e-8))
    feats = list(want.values())
    o_cnt, o_sum, o_sq = oracle.cmvn_stats(feats)
    raw_err = cmvn_err = 0.0
    for p, w in want.items():
        got = np.load(os.path.join(
            out, os.path.splitext(os.path.basename(p))[0] + ".npy"))
        if got.shape != w.shape:
            raise RuntimeError(f"{tag}: {p} shape {got.shape} != {w.shape}")
        raw = got.astype(np.float64) * std + mean
        raw_err = max(raw_err, float(np.abs(raw - w).max()))
        ref = oracle.apply_cmvn(w, o_cnt, o_sum, o_sq)
        cmvn_err = max(cmvn_err, float(np.abs(got - ref).max()))
    log("corpus", run=tag, devices=rep["n_devices"], wall_s=round(wall, 3),
        report_wall_s=round(rep["wall_seconds"], 3),
        audio_s=round(rep["audio_seconds"], 1),
        audio_s_per_s=round(rep["audio_seconds_per_second"], 1),
        stages=json.dumps({k: round(v, 3) for k, v in
                           rep["stage_seconds"].items()}).replace(" ", ""),
        raw_max_err=f"{raw_err:.3e}", cmvn_max_err=f"{cmvn_err:.3e}")
    if raw_err > MFCC_ATOL or cmvn_err > CMVN_ATOL:
        raise RuntimeError(f"{tag}: raw {raw_err:.3e} / cmvn "
                           f"{cmvn_err:.3e} over tolerance")


def phase_corpus(tmp: str, runs):
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    t0 = time.perf_counter()
    paths = write_corpus(corpus)
    cfg = FeatureConfig()
    want = oracle_corpus(paths, cfg)
    log("corpus", n_utts=len(paths), setup_s=round(time.perf_counter() - t0, 2))
    for tag, args in runs:
        check_corpus_run(tag, corpus, os.path.join(tmp, "out_" + tag),
                         want, args)


# ---------------------------------------------------------------- phase 3

def phase_mfcc_batch(rng):
    cfg = FeatureConfig()
    B, n = 64, 160000
    base, inputs = rotated(rng, B, n)
    f, _, _ = mfcc_model.mfcc_batch_jit(*inputs[0], cfg)
    got = np.asarray(f)
    err = max(float(np.abs(got[b] - oracle.mfcc(
        base[b].astype(np.float64), cfg)).max()) for b in range(B))
    sec = timed(lambda a, l: mfcc_model.mfcc_batch_jit(a, l, cfg)[0],
                inputs, 20)
    log("mfcc_batch", shape=f"({B},{n})", max_err=f"{err:.3e}",
        ms=round(sec * 1e3, 3), audio_s_per_s=round(B * n / 16000 / sec, 1))
    if err > MFCC_ATOL:
        raise RuntimeError(f"mfcc_batch_jit error {err:.3e}")
    for prec in ("high", "default"):
        c = cfg.replace(matmul_precision=prec)
        g = np.asarray(mfcc_model.mfcc_batch_jit(*inputs[0], c)[0])
        e = max(float(np.abs(g[b] - oracle.mfcc(
            base[b].astype(np.float64), c)).max()) for b in range(8))
        s = timed(lambda a, l: mfcc_model.mfcc_batch_jit(a, l, c)[0],
                  inputs, 20)
        log("precision", matmul_precision=prec, max_err=f"{e:.3e}",
            audio_s_per_s=round(B * n / 16000 / s, 1))


def contract_speechlike(n: int = 16000, sr: int = 16000) -> np.ndarray:
    """The log-mel contract's speech-like signal (tests/conftest.py)."""
    g = np.random.default_rng(777)
    t = np.arange(n) / sr
    f0 = 110.0 * (1.0 + 0.3 * np.sin(2 * np.pi * 2.5 * t))
    sig = sum((0.5 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
              for k in range(1, 6))
    sig = sig + 0.01 * g.standard_normal(n)
    return (0.8 * sig / np.max(np.abs(sig))).astype(np.float32)


def two_tone(n: int = 16000, sr: int = 16000) -> np.ndarray:
    """The contract's adversarial signal (tests/test_accuracy_floor.py)."""
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * 180.0 * t)
            + 0.3 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)


def logmel_error(x, lens, cfg):
    f, fl, _ = logmel_model.log_mel_batch_jit(jnp.asarray(x),
                                              jnp.asarray(lens), cfg)
    got, fl = np.asarray(f), np.asarray(fl)
    return max(float(np.abs(got[b, : fl[b]] - oracle.log_mel(
        x[b, : lens[b]].astype(np.float64), cfg)).max())
        for b in range(x.shape[0]))


def phase_logmel(rng):
    cfg = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True,
                        dynamic_range_db=50.0).validate()
    x = np.stack([contract_speechlike(), two_tone()])
    lens = np.asarray([16000, 12000], np.int32)       # ragged delta edge
    x[1, 12000:] = 0.0
    errs = [logmel_error(x, lens, cfg.replace(window=w))
            for w in ("hamming", "hann")]
    B, n = 64, 160000
    base, inputs = rotated(rng, B, n)
    wide = logmel_error(base[:8], np.full((8,), n, np.int32), cfg)
    sec = timed(lambda a, l: logmel_model.log_mel_batch_jit(a, l, cfg)[0],
                inputs, 20)
    log("logmel80_deltas", window_db=50,
        contract_max_err_hamming_hann="/".join(f"{e:.3e}" for e in errs),
        speechlike_10s_max_err=f"{wide:.3e}", shape=f"({B},{n})",
        audio_s_per_s=round(B * n / 16000 / sec, 1))
    if max(errs) > LOGMEL_ATOL or wide > LOGMEL_WIDE_ATOL:
        raise RuntimeError(f"log-mel-80+deltas errors {errs} / {wide:.3e}")


def phase_streaming(rng):
    cfg = FeatureConfig()
    S, chunk, n_chunks = 16, 1600, 30
    x = np.stack([speechlike(rng, chunk * n_chunks) for _ in range(S)])
    st = streaming.init_state_batch(S, cfg)
    outs, lat = [[] for _ in range(S)], []
    for k in range(n_chunks):
        ch = jnp.asarray(x[:, None, k * chunk:(k + 1) * chunk])
        t0 = time.perf_counter()
        st, feats, nv = streaming.process_chunks_batch_jit(st, ch, cfg)
        feats, nv = np.asarray(feats), np.asarray(nv)
        lat.append(time.perf_counter() - t0)
        for s in range(S):
            outs[s].append(feats[s, 0, : nv[s, 0]])
    want = np.asarray(mfcc_model.mfcc_batch_jit(
        jnp.asarray(x), jnp.asarray(np.full((S,), x.shape[1], np.int32)),
        cfg)[0])
    err = 0.0
    for s in range(S):
        got = np.concatenate(outs[s])
        err = max(err, float(np.abs(got - want[s, : got.shape[0]]).max()))
    lat = np.asarray(lat[1:]) * 1e3          # first call compiles
    log("streaming", sessions=S, chunk_ms=100, vs_batch_max_err=f"{err:.3e}",
        dispatch_ms_p50=round(float(np.percentile(lat, 50)), 3),
        dispatch_ms_p99=round(float(np.percentile(lat, 99)), 3))
    if err > STREAM_ATOL:
        raise RuntimeError(f"streaming vs batch {err:.3e}")


def pitch_contract_signals(rng, sr: int = 16000):
    """tests/test_pitch.py's tone+silence (2 s) and vibrato (1 s)."""
    t = np.arange(sr) / sr
    voiced = (0.4 * np.sin(2 * np.pi * 220 * t)
              + 0.2 * np.sin(2 * np.pi * 440 * t)
              + 0.01 * rng.standard_normal(sr))
    tone_sil = np.concatenate([voiced, 0.001 * rng.standard_normal(sr)])
    phase = 2 * np.pi * 180.0 * (t + 0.1 / (2 * np.pi * 4.0)
                                 * np.sin(2 * np.pi * 4.0 * t))
    vib = sum(a * np.sin(h * phase) for h, a in ((1, 0.5), (2, 0.25),
                                                 (3, 0.12)))
    vib = vib + 0.02 * rng.standard_normal(sr)
    x = np.zeros((2, 2 * sr), np.float32)
    x[0], x[1, :sr] = tone_sil, vib
    return x, np.asarray([2 * sr, sr], np.int32)


def phase_pitch(rng):
    pcfg = PitchConfig()
    x, lens = pitch_contract_signals(rng)
    feat, fl, _ = pitch_model.pitch_batch_jit(jnp.asarray(x),
                                              jnp.asarray(lens), pcfg)
    feat, fl = np.asarray(feat), np.asarray(fl)
    errs = np.zeros(3)
    for b in range(2):
        w = oracle.pitch(x[b, : lens[b]].astype(np.float64), pcfg)
        errs = np.maximum(errs, np.abs(feat[b, : fl[b]] - w).max(axis=0))

    B, n = 64, 160000
    _, inputs = rotated(rng, B, n)

    @jax.jit
    def stage_resample(a):
        return resample(a, pcfg.sample_rate, pcfg.work_rate,
                        precision=jax.lax.Precision.HIGHEST)

    mask = jnp.ones((B, pcfg.num_frames(n)), bool)

    @jax.jit
    def stage_nccf(xw):
        return pitch_op.nccf(xw, pcfg, mask)

    @jax.jit
    def stage_viterbi(nb):
        return pitch_op.viterbi(nb, pcfg)

    xws = [(stage_resample(a),) for a, _ in inputs]
    nbs = [(stage_nccf(xw)[0],) for (xw,) in xws]
    t_res = timed(stage_resample, [(a,) for a, _ in inputs], 10)
    t_nccf = timed(stage_nccf, xws, 10)
    t_vit = timed(stage_viterbi, nbs, 5)
    t_all = timed(lambda a, l: pitch_model.pitch_batch_jit(a, l, pcfg)[0],
                  inputs, 5)
    big = np.asarray(pitch_model.pitch_batch_jit(*inputs[0], pcfg)[0])
    log("pitch", contract_max_err_pov_norm_delta="/".join(
            f"{e:.3e}" for e in errs), shape=f"({B},{n})",
        resample_ms=round(t_res * 1e3, 3), nccf_ms=round(t_nccf * 1e3, 3),
        viterbi_ms=round(t_vit * 1e3, 3), total_ms=round(t_all * 1e3, 3),
        audio_s_per_s=round(B * n / 16000 / t_all, 1))
    if np.any(errs > np.asarray(PITCH_ATOL)):
        raise RuntimeError(f"pitch errors {errs}")
    if big.shape != (B, pcfg.num_frames(n), 3) or not np.isfinite(big).all():
        raise RuntimeError(f"pitch batch output {big.shape} not finite")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded corpus run")
    args = ap.parse_args()
    dev = phase_device(4 if args.four else 1)
    rng = np.random.default_rng(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            phase_corpus(tmp, [("four_gpu_padded", ["--batch-size", "16"])])
        else:
            phase_corpus(tmp, [("padded", []), ("padded_warm", []),
                               ("packed", ["--pack"])])
    if not args.four:
        phase_mfcc_batch(rng)
        phase_logmel(rng)
        phase_streaming(rng)
        phase_pitch(rng)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
