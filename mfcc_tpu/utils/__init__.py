"""Host-side utilities: ragged batching, WAV IO, manifests, logging.

The analogs of the reference's utility layer (vector/hash containers,
``DPRINT`` diagnostics — SURVEY.md §2 items 8-10): here the "containers"
are ragged-batch bucketing with padding masks, IO is a WAV reader with an
optional native C++ fast path, and diagnostics are structured run reports
plus ``jax.profiler`` hooks.
"""

from . import batch, wav, manifest, report  # noqa: F401
