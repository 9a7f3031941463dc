"""Long-form single-stream pitch tracking with the blocked Viterbi.

    python examples/longform_pitch.py [wav] [--minutes 2]

The exact Viterbi smoother is a T-step sequential `lax.scan`; at batch
size 64 its steps amortize across utterances, but a SINGLE long stream
(audiobook, meeting, broadcast) has no batch dimension to hide behind.
`viterbi_block=` opts into the blocked warm-up Viterbi: time chunks are
solved in parallel with zero-emission-padded context, cutting the
sequential chain from T to block + 2*warm steps.  Its speed on the GPU
is not measured yet.

Contract (docs/conventions.md): the blocked path may deviate from the
exact one ONLY on zero-voicing-evidence silence frames; every frame
with any voicing evidence gets the exact track.  For batch corpus runs
keep the default exact smoother (blocked LOSES there).
"""

import argparse

import numpy as np
import jax.numpy as jnp

from mfcc_tpu.config import PitchConfig
from mfcc_tpu.ops import pitch as pitch_op
from mfcc_tpu.utils import wav


def synth_longform(minutes: float, sr: int = 16000) -> np.ndarray:
    """Speech-like stand-in: alternating voiced vibrato / noise /
    near-silence, one second per segment."""
    rng = np.random.default_rng(0)
    segs = []
    f0s = [120.0, 220.0, 90.0, 300.0, 180.0]
    for i in range(int(minutes * 60)):
        t = np.arange(sr) / sr
        if i % 3 == 0:
            f0 = f0s[i % len(f0s)]
            ph = 2 * np.pi * f0 * (t + 0.02 * np.sin(2 * np.pi * 3 * t))
            x = (0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph)
                 + 0.02 * rng.standard_normal(sr))
        elif i % 3 == 1:
            x = 0.1 * rng.standard_normal(sr)
        else:
            x = 0.002 * rng.standard_normal(sr)
        segs.append(x)
    return np.concatenate(segs).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?", help="input WAV (else synthetic)")
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--block", type=int, default=320,
                    help="blocked-Viterbi chunk frames")
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--nccf-chunk", type=int, default=0,
                    help="chunked NCCF (frames per chunk folded into the "
                         "batch axis; 0 = off)")
    args = ap.parse_args()

    if args.wav:
        x, sr = wav.read_wav(args.wav)
        pcfg = PitchConfig(sample_rate=sr).validate()
    else:
        x = synth_longform(args.minutes)
        pcfg = PitchConfig().validate()

    xb = jnp.asarray(x)[None, :]
    lens = jnp.asarray([x.shape[-1]], jnp.int32)
    f0, voicing, mask = pitch_op.pitch_track(
        xb, lens, pcfg, viterbi_block=args.block, viterbi_warm=args.warm,
        nccf_chunk=args.nccf_chunk or None)
    f0 = np.asarray(f0)[0]
    voicing = np.asarray(voicing)[0]
    valid = np.asarray(mask)[0]

    voiced = valid & (voicing > 0.5)
    dur = x.shape[-1] / pcfg.sample_rate
    print(f"{dur:.0f} s of audio -> {int(valid.sum())} pitch frames "
          f"({voiced.mean():.0%} voiced)")
    if voiced.any():
        print(f"voiced f0: median {np.median(f0[voiced]):.1f} Hz, "
              f"p10-p90 {np.percentile(f0[voiced], 10):.1f}-"
              f"{np.percentile(f0[voiced], 90):.1f} Hz")


if __name__ == "__main__":
    main()
