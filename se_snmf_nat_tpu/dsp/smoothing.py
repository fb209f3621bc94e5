"""Temporal smoothing primitives.

tf_dd: first-order decision-directed smoothing along time
(src/TF_DD.m: X[l] = a*X[l-1] + (1-a)*X[l], X[0] unchanged).

The JAX variant uses an associative scan so long spectrograms parallelize
across the time axis on the device instead of running a length-T serial loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def tf_dd(x: np.ndarray, alpha: float) -> np.ndarray:
    """NumPy reference (training path; (K, T) layout like the MATLAB)."""
    out = np.array(x, dtype=np.float64, copy=True)
    for l in range(1, out.shape[1]):
        out[:, l] = alpha * out[:, l - 1] + (1.0 - alpha) * x[:, l]
    return out


def tf_dd_jax(x: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """(T, K) time-major JAX version via associative_scan.

    y[t] = alpha*y[t-1] + (1-alpha)*x[t] is the linear recurrence
    (a, b) ∘ (a', b') = (a*a', a'*b + b'); first element kept as x[0].
    """
    t = x.shape[0]
    a = jnp.full((t,), alpha, x.dtype).at[0].set(0.0)
    b = ((1.0 - alpha) * x).at[0].set(x[0])
    a_b = a[:, None] if x.ndim == 2 else a

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, y = jax.lax.associative_scan(combine, (jnp.broadcast_to(a_b, x.shape), b))
    return y
