"""Execution backend registry.

- ``xla``  — hop-block GEMM jnp pipeline: the one path, and the reference
             any future kernel is tested against
- ``auto`` — the measured winner, ``xla``

A hand-written kernel joins this registry only if it beats ``xla`` end to
end on the GPU (docs/kernels.md).  Selection is a static jit argument.
"""

from __future__ import annotations

BACKENDS = ("auto", "xla")


def resolve(name: str = "auto", cfg=None) -> str:
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    return "xla"
