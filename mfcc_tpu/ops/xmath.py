"""Accurate elementwise math for feature pipelines.

Hardware transcendental units are fast approximations: XLA CPU's f32 ``log``
has ~1e-4 *absolute* error (measured in tests/test_xmath.py) — alone it can
consume the pipeline's entire 1e-4 feature tolerance.  Log compression sits directly on the feature
contract, so this module provides an accurate f32 ``log`` from exact integer
exponent extraction plus an odd atanh series on the centered mantissa:

    x = m * 2^e,  m in [sqrt(2)/2, sqrt(2))
    r = (m - 1) / (m + 1)            |r| <= 0.1716
    log(m) = 2 * (r + r^3/3 + r^5/5 + r^7/7 + r^9/9)
    log(x) = e * ln2 + log(m)

The r^9 truncation error is < 6e-10; total error ~1 f32 ulp.  Cost is ~15
vector FLOPs per element — noise next to the DFT GEMMs — and the result is
bit-deterministic across CPU and GPU backends (a reproducibility win the
hardware LUTs can't give).

Valid for finite x > 0; callers clamp with a log floor first (the pipeline
always does ``log(max(E, floor))`` with floor >= 1e-30, above denormals).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_LN2 = float(np.log(2.0))
_SQRT2 = float(np.sqrt(2.0))


@jax.custom_jvp
def accurate_log(x: jnp.ndarray) -> jnp.ndarray:
    """Accurate natural log for finite positive float32 inputs.

    custom_jvp: the exponent-bit extraction below is a bitcast chain with
    no derivative, so autodiff is given the analytic d/dx log(x) = 1/x
    (trainable front-ends differentiate through the log compression).
    """
    x = x.astype(jnp.float32)
    bits = x.view(jnp.int32) if hasattr(x, "view") else jnp.asarray(x).view(jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = jnp.bitwise_or(
        jnp.bitwise_and(bits, jnp.int32(0x007FFFFF)), jnp.int32(0x3F800000)
    ).view(jnp.float32)
    # center mantissa into [sqrt(2)/2, sqrt(2)) so |r| stays small
    big = m >= _SQRT2
    m = jnp.where(big, m * 0.5, m)
    e = (e + big.astype(jnp.int32)).astype(jnp.float32)
    r = (m - 1.0) / (m + 1.0)
    r2 = r * r
    # Horner over the odd series 2*atanh(r)
    p = 2.0 / 9.0
    p = p * r2 + 2.0 / 7.0
    p = p * r2 + 2.0 / 5.0
    p = p * r2 + 2.0 / 3.0
    p = p * r2 + 2.0
    return e * _LN2 + r * p


@accurate_log.defjvp
def _accurate_log_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    return accurate_log(x), dx / x


def floored_log(x: jnp.ndarray, floor: float) -> jnp.ndarray:
    """log(max(x, floor)) with the accurate log."""
    return accurate_log(jnp.maximum(x, jnp.asarray(floor, jnp.float32)))
