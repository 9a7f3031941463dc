"""Global cepstral mean/variance normalization (CMVN) via collectives.

Corpus statistics are the only cross-utterance (and cross-host) coupling in
the whole pipeline, and they are tiny — three (F,) vectors — so the design
keeps tensors host-local and reduces only these statistics globally:

- :func:`batch_stats` — masked (count, sum, sumsq) from one padded batch.
  Padded frames are zeroed by the pipeline *and* masked here, so statistics
  are exact (SURVEY.md §7 hard part 4).
- :class:`Stats` — additive pytree; ``merge`` accumulates across batches,
  and under jit with batch-sharded inputs the reduction over the "data"
  axis lowers to an XLA psum over ICI/DCN automatically.  An explicit
  shard_map/psum variant (:func:`batch_stats_psum`) exercises the same
  collective path manually for the multi-host dry run.
- :func:`apply` — (x - mean) / std with variance flooring.

Checkpoint/resume of the accumulator is in utils/manifest.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import DATA_AXIS


class Stats(NamedTuple):
    """Additive CMVN statistics over frames (pytree of f32)."""
    count: jnp.ndarray   # ()     total frames
    sum: jnp.ndarray     # (F,)
    sumsq: jnp.ndarray   # (F,)

    @staticmethod
    def zero(n_feats: int) -> "Stats":
        return Stats(jnp.zeros((), jnp.float32),
                     jnp.zeros((n_feats,), jnp.float32),
                     jnp.zeros((n_feats,), jnp.float32))

    def merge(self, other: "Stats") -> "Stats":
        return Stats(self.count + other.count,
                     self.sum + other.sum,
                     self.sumsq + other.sumsq)

    def mean_var(self, eps: float = 1e-8):
        c = jnp.maximum(self.count, 1.0)
        mean = self.sum / c
        var = jnp.maximum(self.sumsq / c - mean * mean, eps)
        return mean, var


def batch_stats(feat: jnp.ndarray, mask: jnp.ndarray) -> Stats:
    """(B, T, F) features + (B, T) mask -> masked Stats.

    Works on sharded inputs under jit: the batch-axis reductions become
    cross-device psums inserted by the SPMD partitioner.

    Precision note: on-device stats are f32 (JAX runs without x64), and
    variance later comes from sumsq/n - mean^2 — for cepstra with
    |mean| >> std that cancellation bounds normalized-feature accuracy at
    ~5e-4 (measured).  Fine for on-device serving/training normalization;
    the corpus runner instead accumulates float64 on the host
    (runner._host_batch_stats) to keep the 1e-4 feature contract.
    """
    m = mask.astype(jnp.float32)
    fm = feat * m[..., None]
    return Stats(
        count=jnp.sum(m),
        sum=jnp.sum(fm, axis=(0, 1)),
        sumsq=jnp.sum(fm * feat, axis=(0, 1)),
    )


def batch_stats_psum(feat: jnp.ndarray, mask: jnp.ndarray, mesh) -> Stats:
    """Explicit shard_map + psum formulation of batch_stats.

    Semantically identical; exists to pin the collective design (psum of
    bytes-sized stats over the "data" axis) for the multi-host path and to
    be testable on a fake pod (8 CPU devices).
    """
    from jax import shard_map

    def local(f, m):
        s = batch_stats(f, m)
        return Stats(*(jax.lax.psum(x, DATA_AXIS) for x in s))

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
    )(feat, mask)


def apply(feat: jnp.ndarray, stats: Stats, eps: float = 1e-8) -> jnp.ndarray:
    """Normalize features with global statistics."""
    mean, var = stats.mean_var(eps)
    return (feat - mean) * jax.lax.rsqrt(var)
