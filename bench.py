"""Throughput benchmark — prints ONE JSON line.

Measures the flagship pipeline (batched ragged MFCC-13, 16 kHz,
25 ms / 10 ms) on whatever accelerator JAX finds, with inputs resident in
device memory.

Protocol: the headline runs K pipeline iterations inside ONE dispatch via
lax.scan, with a scalar carry folded into the next iteration's input so
XLA cannot hoist the loop body (each iteration adds one elementwise pass
over the audio).  Completion is a host fetch of the scalar carry, which
depends on every iteration.  The per-dispatch number (one dispatch per
batch, as production serving runs) is reported beside it.

Metric: audio-seconds of input processed per wall-second per device.
Baseline (BASELINE.md): 10,000 audio-sec/s/chip -> vs_baseline = value/1e4.
Also reports max abs feature error vs the float64 oracle as a gate, and
the device the numbers were taken on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64, help="utterances/batch")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="audio seconds per utterance")
    ap.add_argument("--scan", type=int, default=20,
                    help="pipeline iterations per dispatch (lax.scan)")
    ap.add_argument("--iters", type=int, default=5,
                    help="dispatches per timed repeat")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed repeats (median reported)")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes for CPU smoke runs")
    ap.add_argument("--algo", default="auto",
                    choices=("auto", "direct", "directc", "dit2", "dit2c",
                             "dit4c"),
                    help="DFT factorization (cfg.dft_algorithm)")
    from mfcc_tpu.backend import BACKENDS
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mfcc_tpu import FeatureConfig, oracle
    from mfcc_tpu.models import mfcc as mfcc_model
    from mfcc_tpu.utils import compile_cache
    compile_cache.enable()

    if args.small:
        args.batch, args.seconds = 4, 2.0
        args.scan, args.iters, args.repeats = 2, 2, 2

    cfg = FeatureConfig(dft_algorithm=args.algo)
    sr = cfg.sample_rate
    n = int(args.seconds * sr)
    rng = np.random.default_rng(0)
    # speech-like content (tones+noise): exercises real dynamic range
    t = np.arange(n) / sr
    base = (0.3 * np.sin(2 * np.pi * 180 * t)
            + 0.1 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    audio = np.tile(base, (args.batch, 1))
    audio += 0.02 * rng.standard_normal(audio.shape).astype(np.float32)
    lengths = np.full((args.batch,), n, np.int32)

    dev = jax.devices()[0]
    audio_d = jax.device_put(jnp.asarray(audio), dev)
    lengths_d = jax.device_put(jnp.asarray(lengths), dev)

    # accuracy gate on one utterance
    feat_b, flens, _ = mfcc_model.mfcc_batch_jit(
        audio_d, lengths_d, cfg, args.backend)
    got = np.asarray(feat_b[0])
    want = oracle.mfcc(audio[0].astype(np.float64), cfg)
    max_err = float(np.abs(got[: want.shape[0]] - want).max())

    # ---- headline: K iterations per dispatch, serialized by a carry ----
    from functools import partial

    @partial(jax.jit, static_argnames=("c_", "b_"))
    def scan_fn(a, l, c_=cfg, b_=args.backend):
        def body(carry, _):
            f, fl, m = mfcc_model.mfcc_batch(a + carry, l, c_, b_)
            return (f[0, 0, 0] * jnp.float32(1e-30)).astype(a.dtype), None
        out, _ = jax.lax.scan(body, jnp.zeros((), a.dtype), None,
                              length=args.scan)
        return out

    t0 = time.perf_counter()
    np.asarray(scan_fn(audio_d, lengths_d))   # compile + warm
    compile_s = time.perf_counter() - t0

    def timed(fn, per_call_audio_sec, iters):
        reps = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = fn()
            np.asarray(out)                   # force completion
            reps.append(per_call_audio_sec * iters
                        / (time.perf_counter() - t0))
        return reps

    batch_audio_sec = args.batch * args.seconds
    scan_reps = timed(lambda: scan_fn(audio_d, lengths_d),
                      batch_audio_sec * args.scan, args.iters)

    # ---- secondary: per-dispatch (includes host round-trip) ----
    def one():
        f, fl, m = mfcc_model.mfcc_batch_jit(audio_d, lengths_d, cfg,
                                             args.backend)
        return f[0, 0, 0]

    disp_reps = timed(one, batch_audio_sec, max(args.iters * args.scan, 20))

    value = statistics.median(scan_reps)
    print(json.dumps({
        "metric": "audio_seconds_per_s_per_chip",
        "value": round(value, 1),
        "unit": "audio-sec/s/chip",
        "vs_baseline": round(value / 10_000.0, 3),
        "max_abs_error_vs_oracle": max_err,
        "protocol": {"scan": args.scan, "iters": args.iters,
                     "repeats": args.repeats, "batch": args.batch,
                     "utt_seconds": args.seconds,
                     "note": ("on-device scan serialized by a scalar carry;"
                              " completion via host fetch")},
        "scan_reps": [round(r, 1) for r in scan_reps],
        "per_dispatch_median": round(statistics.median(disp_reps), 1),
        "per_dispatch_reps": [round(r, 1) for r in disp_reps],
        "backend": args.backend, "algo": args.algo,
        "compile_or_cache_load_s": round(compile_s, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }))


if __name__ == "__main__":
    main()
