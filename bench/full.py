"""Full benchmark matrix -> BASELINE.md numbers.

Measures every baseline config (BASELINE.md table) on the current device:
  1. single-WAV parity (accuracy, CPU-oracle differential)
  2. batched-64 ragged MFCC-13 throughput
  3. log-mel-80 + deltas throughput
  4. streaming chunked STFT (latency + throughput)
  5. multi-host CMVN — functional validation only (see __graft_entry__
     and chip_smoke.py --four)

Protocol: ALL batch-pipeline throughput rows use the scan protocol — K
pipeline iterations inside ONE dispatch via ``lax.scan`` serialized by a
scalar carry, completion forced by a host fetch — matching bench.py.  The
only per-dispatch rows are the streaming LATENCY metrics, where one
dispatch per chunk IS the quantity being measured.

Usage: python bench/full.py [--iters N] [--small]
Prints the results as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mfcc_tpu import FeatureConfig, oracle
    from mfcc_tpu.utils import compile_cache
    compile_cache.enable()
    from mfcc_tpu.models import (mfcc as mfcc_model, logmel as logmel_model,
                                 streaming)

    B, sec, iters = (4, 2.0, 3) if args.small else (64, 10.0, args.iters)
    sr = 16000
    n = int(sec * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (B, 1)) + 0.02 * rng.standard_normal(
        (B, n)).astype(np.float32)
    # ragged: vary lengths across the batch
    lengths = np.linspace(n // 2, n, B).astype(np.int32)
    audio_sec_total = float(lengths.sum()) / sr

    dev = jax.devices()[0]
    ad = jax.device_put(jnp.asarray(audio), dev)
    ld = jax.device_put(jnp.asarray(lengths), dev)
    results = {"device": {"platform": dev.platform,
                          "kind": dev.device_kind,
                          "count": jax.device_count()},
               "batch": B, "utt_seconds": sec}

    def timed(fn, *a, n_iter=iters):
        """Per-dispatch timing — used ONLY where a dispatch per call is
        the thing being measured (streaming latency rows)."""
        out = fn(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n_iter

    SCAN = 4 if args.small else 20

    def scan_timed(pipe, n_iter=iters):
        """Scan-protocol timing of a full-pipeline fn x -> features: K
        iterations inside one dispatch, serialized by a scalar carry
        folded into the input; completion forced by a host fetch."""
        def g():
            def body(carry, _):
                out = pipe(ad + carry)
                return (out.ravel()[0] * jnp.float32(1e-30)).astype(
                    ad.dtype), None
            c, _ = jax.lax.scan(body, jnp.zeros((), ad.dtype), None,
                                length=SCAN)
            return c
        gj = jax.jit(g)
        np.asarray(gj())               # compile + warm the fetch path
        t0 = time.perf_counter()
        out = None
        for _ in range(n_iter):
            out = gj()
        np.asarray(out)
        return (time.perf_counter() - t0) / (n_iter * SCAN)

    # config 1: accuracy
    cfg = FeatureConfig()
    feat, flens, _ = mfcc_model.mfcc_batch_jit(ad, ld, cfg)
    i0 = int(np.argmax(lengths))
    got = np.asarray(feat[i0])[: int(flens[i0])]
    want = oracle.mfcc(audio[i0][: lengths[i0]].astype(np.float64), cfg)
    results["config1_single_wav"] = {
        "max_abs_error_vs_oracle": float(np.abs(got - want).max())}

    # config 2: batched ragged MFCC-13 (scan protocol)
    dt = scan_timed(lambda x: mfcc_model.mfcc_batch(x, ld, cfg)[0])
    results["config2_batched_mfcc13"] = {
        "audio_sec_per_s": audio_sec_total / dt, "wall_s_per_batch": dt,
        "protocol": "scan-carry-v2",
        "note": "REAL audio-sec over ragged batch (lengths n/2..n, mean "
                "0.75n) while compute runs the padded (B, n) program — "
                "i.e. the utilization-discounted corpus rate; bench.py's "
                "headline measures the same program on full-length "
                "utterances"}

    # config 2b (r5): SPLIT-PACKED ragged — same length distribution,
    # utterances split across rows at frame boundaries so the (B, n)
    # program's rows fill to ~100% (utils/batch.pack_rows_split +
    # mfcc_batch_packed; per-piece features bit-identical to standalone,
    # tests/test_packing.py)
    from mfcc_tpu.utils import batch as batch_lib
    stream = [(i, int(lengths[i % B])) for i in range(4 * B)]
    rows_s = list(batch_lib.pack_rows_split(
        stream, capacity=n, hop=cfg.hop_len,
        frame_len=cfg.frame_len))[:B]
    Ss = max(len(r.segments) for r in rows_s)
    xs_p = np.zeros((B, n), np.float32)
    starts_s = np.zeros((B, Ss), np.int32)
    lens_s = np.zeros((B, Ss), np.int32)
    real = 0
    for bb, row in enumerate(rows_s):
        sig_p, st, ln, pcs = batch_lib.pack_audio_split(
            row, lambda uid: np.tile(base, -(-int(lengths[uid % B]) // n)
                                     )[: int(lengths[uid % B])])
        xs_p[bb] = sig_p
        starts_s[bb, : len(st)], lens_s[bb, : len(ln)] = st, ln
        real += sum(pc.n_frames for pc in pcs) * cfg.hop_len
    xsd = jax.device_put(jnp.asarray(xs_p), dev)
    stsd = jax.device_put(jnp.asarray(starts_s), dev)
    lnsd = jax.device_put(jnp.asarray(lens_s), dev)
    # scan_timed closes over `ad`; time the packed pipe on its own input
    def scan_timed_on(pipe, x0):
        def g():
            def body(carry, _):
                out = pipe(x0 + carry)
                return (out.ravel()[0] * jnp.float32(1e-30)).astype(
                    x0.dtype), None
            c, _ = jax.lax.scan(body, jnp.zeros((), x0.dtype), None,
                                length=SCAN)
            return c
        gj = jax.jit(g)
        np.asarray(gj())
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = gj()
        np.asarray(out)
        return (time.perf_counter() - t0) / (iters * SCAN)

    dtp2 = scan_timed_on(lambda x: mfcc_model.mfcc_batch_packed(
        x, stsd, lnsd, cfg)[0], xsd)
    results["config2b_packed_mfcc13"] = {
        "real_audio_sec_per_s": (real / sr) / dtp2,
        "fill_frames_x_hop": real / (B * n),
        "protocol": "scan-carry-v2",
        "note": "split-packed rows at the headline (B, n) shape: the "
                "ragged corpus utilization recovery"}

    # config 3: log-mel-80 + deltas (scan protocol).  Accuracy reported
    # for the plain definition AND with an 80 dB dynamic-range floor:
    # unbounded-range log of near-cancelled spectral valleys is not
    # resolvable in f32 on ANY backend (see ops/mel.py /
    # FeatureConfig.dynamic_range_db; the strict 1e-4 contract point is
    # a 50 dB window, docs/conventions.md).
    cfg3 = FeatureConfig(n_mels=80, n_mfcc=80, deltas=True).validate()
    dt = scan_timed(lambda x: logmel_model.log_mel_batch(x, ld, cfg3)[0])
    i0feat, i0len, _ = logmel_model.log_mel_batch_jit(ad, ld, cfg3)
    got3 = np.asarray(i0feat[i0])[: int(i0len[i0])]
    want3 = oracle.log_mel(audio[i0][: lengths[i0]].astype(np.float64), cfg3)
    cfg3f = cfg3.replace(dynamic_range_db=80.0)
    f3, l3, _ = logmel_model.log_mel_batch_jit(ad, ld, cfg3f)
    got3f = np.asarray(f3[i0])[: int(l3[i0])]
    want3f = oracle.log_mel(audio[i0][: lengths[i0]].astype(np.float64), cfg3f)
    # the COMMITTED accuracy contract point (BASELINE.md /
    # tests/test_accuracy_floor.py): 50 dB window, strict 1e-4
    cfg3c = cfg3.replace(dynamic_range_db=50.0)
    f3c, l3c, _ = logmel_model.log_mel_batch_jit(ad, ld, cfg3c)
    got3c = np.asarray(f3c[i0])[: int(l3c[i0])]
    want3c = oracle.log_mel(audio[i0][: lengths[i0]].astype(np.float64), cfg3c)
    results["config3_logmel80_deltas"] = {
        "audio_sec_per_s": audio_sec_total / dt,
        "protocol": "scan-carry-v2",
        "max_abs_error_vs_oracle_50db_contract": float(
            np.abs(got3c - want3c).max()),
        "contract": "dynamic_range_db=50 is the committed 1e-4 contract "
                    "point (tests/test_accuracy_floor.py); the rows below "
                    "are wider windows where f32 valley cancellation "
                    "exceeds 1e-4 on every backend (docs/conventions.md)",
        "max_abs_error_vs_oracle_unbounded_range": float(
            np.abs(got3 - want3).max()),
        "max_abs_error_vs_oracle_80db_floor": float(
            np.abs(got3f - want3f).max())}

    # spectrogram family (T, 257) log power spectra — scan protocol
    # (50 dB window contract 2e-4, models/spectrogram.py)
    from mfcc_tpu.models import spectrogram as spec_model
    wants = oracle.log_spectrogram(audio[i0][: lengths[i0]].astype(np.float64),
                                   cfg)
    keep = wants > (wants.max(axis=1, keepdims=True) - np.log(10.0 ** 5))
    dts = scan_timed(lambda x: spec_model.log_spectrogram_batch(
        x, ld, cfg)[0])
    fs, ls, _ = spec_model.log_spectrogram_batch_jit(ad, ld, cfg)
    gots = np.asarray(fs[i0])[: int(ls[i0])]
    results["spectrogram_257"] = {
        "protocol": "scan-carry-v2",
        "note": "ragged real-audio rate (utilization-discounted, see "
                "config2 note)",
        "audio_sec_per_s": audio_sec_total / dts,
        "max_abs_error_vs_oracle_50db_window": float(
            np.abs(gots[keep] - wants[keep]).max()),
        "max_abs_error_vs_oracle_unbounded": float(
            np.abs(gots - wants).max())}

    # PLP family (13-dim cepstra from bark/loudness/LPC) — scan protocol
    from mfcc_tpu.models import plp as plp_model
    dtq = scan_timed(lambda x: plp_model.plp_batch(x, ld, cfg)[0])
    fq, lq, _ = plp_model.plp_batch_jit(ad, ld, cfg)
    gotq = np.asarray(fq[i0])[: int(lq[i0])]
    wantq = oracle.plp(audio[i0][: lengths[i0]].astype(np.float64), cfg)
    results["plp_13"] = {
        "audio_sec_per_s": audio_sec_total / dtq,
        "protocol": "scan-carry-v2",
        "note": "ragged real-audio rate (utilization-discounted, see "
                "config2 note)",
        "max_abs_error_vs_oracle": float(np.abs(gotq - wantq).max())}

    # pitch family (r2; scan protocol since r3): 3-dim NCCF+Viterbi
    # features on the same ragged batch.
    from mfcc_tpu.config import PitchConfig
    from mfcc_tpu.models import pitch as pitch_model
    pcfg = PitchConfig().validate()
    dtp = scan_timed(lambda x: pitch_model.pitch_batch(x, ld, pcfg)[0])
    fp, lp, _ = pitch_model.pitch_batch_jit(ad, ld, pcfg)
    gotp = np.asarray(fp[i0])[: int(lp[i0])]
    wantp = oracle.pitch(audio[i0][: lengths[i0]].astype(np.float64), pcfg)
    results["pitch_3dim"] = {
        "audio_sec_per_s": audio_sec_total / dtp,
        "wall_s_per_batch": dtp,
        "note": "ragged real-audio rate (utilization-discounted, see "
                "config2 note)",
        "protocol": "scan-carry-v2",
        "max_abs_error_vs_oracle": float(
            np.abs(gotp - wantp[: gotp.shape[0]]).max())}

    # config 4: streaming (chunk = 64 frames = 640 ms)
    chunk_frames = 8 if args.small else 64
    C = chunk_frames * cfg.hop_len
    xs = audio[0][: (n // C) * C]
    dt = timed(lambda: streaming.stream_signal(jnp.asarray(xs), cfg,
                                               chunk_frames)[0])
    feats, total = streaming.stream_signal(jnp.asarray(xs), cfg, chunk_frames)
    want4 = oracle.mfcc(xs.astype(np.float64), cfg)[: int(total)]
    nz = np.where(np.any(np.asarray(feats) != 0.0, axis=1))[0][: want4.shape[0]]
    err4 = float(np.abs(np.asarray(feats)[nz] - want4).max())
    # single-chunk dispatch (latency) vs K-chunks-per-dispatch (amortized
    # single-stream throughput) vs B-sessions-per-dispatch (serving)
    st1 = streaming.init_state(cfg)
    one = jnp.asarray(xs[:C])
    dt1 = timed(lambda: streaming.process_chunk_jit(st1, one, cfg)[1])
    K = len(xs) // C
    chunks = jnp.asarray(xs.reshape(K, C))
    dtk = timed(lambda: streaming.process_chunks_jit(st1, chunks, cfg)[1])
    Bs = 4 if args.small else 64
    stb = streaming.init_state_batch(Bs, cfg)
    cb = jnp.asarray(np.tile(xs[:C], (Bs, 1)))
    dtb = timed(lambda: streaming.process_chunk_batch_jit(stb, cb, cfg)[1])
    results["config4_streaming"] = {
        "audio_sec_per_s_scan_driver": (len(xs) / sr) / dt,
        "chunk_ms": 1000.0 * C / sr,
        "single_chunk_dispatch_latency_ms": 1000.0 * dt1,
        "single_stream_audio_sec_per_s_1chunk": (C / sr) / dt1,
        "single_stream_audio_sec_per_s_Kchunks": (len(xs) / sr) / dtk,
        "chunks_per_dispatch_K": K,
        "serving_sessions": Bs,
        "serving_audio_sec_per_s": Bs * (C / sr) / dtb,
        "serving_per_dispatch_latency_ms": 1000.0 * dtb,
        "max_abs_error_vs_oracle": err4}

    # config 5: functional multi-host validation is covered by
    # __graft_entry__.dryrun_multichip, the multi-process runner tests
    # and chip_smoke.py --four
    results["config5_multihost"] = {
        "validated": "dryrun_multichip + multi-process runner e2e",
        "n_devices_here": jax.device_count()}
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
