"""Multichannel nonnegative tensor factorization (CP/PARAFAC, KL MU).

Reference: src/GIST_NTF_C.m / src/GIST_NTF.m — factorize a (C, N, M)
channel x frequency x time magnitude tensor as
X_hat[c,n,m] = sum_k C[c,k] B[n,k] A[m,k] with the spectral basis B fixed,
multiplicative KL updates on the channel loadings C (shipped config:
C_UPDATE=1, A_UPDATE=0, A=ones — GIST_NTF_C.m:4-15) and optionally on the
activations A.

Re-design: the reference materializes Khatri-Rao products and matricized
unfoldings (GIST_NTF_C.m:39-43,88-129); here every contraction is a single
einsum XLA maps onto matrix units, and the O-side denominators collapse
analytically (the unfolding of an all-ones tensor contracted with A(.)B is a
rank-1 outer product of column sums).  Early stopping runs in a
lax.while_loop so the whole solve jits.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from se_snmf_nat_tpu.utils.matlab_compat import MatlabTwister


def khatri_rao(*mats: jnp.ndarray) -> jnp.ndarray:
    """Columnwise Kronecker product (src/kr.m): column k of the result is
    kron(U1[:,k], U2[:,k], ...)."""
    k = mats[0].shape[1]
    x = mats[-1]
    for u in mats[-2::-1]:
        x = (u[:, None, :] * x[None, :, :]).reshape(-1, k)
    if x.shape[1] != k:
        raise ValueError("column mismatch")
    return x


class NtfResult(NamedTuple):
    c: jnp.ndarray       # (C, K) channel loadings
    a: jnp.ndarray       # (M, K) activations
    iters: jnp.ndarray
    div: jnp.ndarray
    cost: jnp.ndarray


def default_c_init(n_ch: int, k: int) -> jnp.ndarray:
    """The reference's un-seeded rand(Channel, K) (GIST_NTF_C.m:13) drawn
    from MATLAB's startup Twister stream for determinism."""
    return jnp.asarray(MatlabTwister(0).rand(n_ch, k))


@partial(jax.jit, static_argnames=("max_iter", "update_c", "update_a",
                                   "sparsity", "conv_eps", "flr"))
def ntf_solve(s_mag: jnp.ndarray, b: jnp.ndarray, c0: jnp.ndarray,
              a0: jnp.ndarray, *, sparsity: float = 5.0,
              max_iter: int = 100, conv_eps: float = 1e-3,
              flr: float = 1e-9, update_c: bool = True,
              update_a: bool = False) -> NtfResult:
    """s_mag: (C, N, M) nonnegative tensor; b: (N, K) fixed basis;
    c0: (C, K); a0: (M, K) (ones in the shipped config)."""
    dtype = s_mag.dtype
    flr = jnp.asarray(flr, dtype)
    sp = jnp.asarray(sparsity, dtype)

    # normalize B columns, rescale C (GIST_NTF_C.m:27-30)
    bn = jnp.sqrt(jnp.sum(b * b, axis=0))
    b = b / jnp.where(bn > 0, bn, 1.0)
    c0 = c0 * bn[None, :]

    sum_b = jnp.sum(b, axis=0)                     # (K,)

    def xhat_p(c, a):
        xh = jnp.einsum("ck,nk,mk->cnm", c, b, a)
        xh = jnp.maximum(xh, flr)
        return xh, jnp.maximum(s_mag / xh, flr)

    def cost_of(c, xh):
        div = jnp.sum(s_mag * jnp.log(s_mag / xh) - s_mag + xh)
        return div, div + jnp.sum(sp * c)

    def body(carry):
        it, c, a, last_cost, _ = carry
        if update_a:
            _, pt = xhat_p(c, a)
            pcb = jnp.maximum(jnp.einsum("cnm,ck,nk->mk", pt, c, b), flr)
            ocb = jnp.maximum(
                (jnp.sum(c, axis=0) * sum_b)[None, :]
                * jnp.ones((a.shape[0], 1), dtype), flr)
            a = jnp.maximum(a * pcb / (ocb + sp), flr)
        if update_c:
            _, pt = xhat_p(c, a)
            pba = jnp.maximum(jnp.einsum("cnm,nk,mk->ck", pt, b, a), flr)
            oba = jnp.maximum(
                (sum_b * jnp.sum(a, axis=0))[None, :]
                * jnp.ones((c.shape[0], 1), dtype), flr)
            c = jnp.maximum(c * pba / (oba + sp), flr)
        xh, _ = xhat_p(c, a)
        div, cost = cost_of(c, xh)
        rel = jnp.abs(cost - last_cost) / jnp.abs(last_cost)
        done = jnp.logical_and(it > 0, rel < conv_eps) \
            if conv_eps > 0 else jnp.asarray(False)
        return it + 1, c, a, cost, done

    def cond(carry):
        it, *_, done = carry
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    init = (jnp.asarray(0, jnp.int32), c0.astype(dtype), a0.astype(dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(False))
    it, c, a, cost, _ = lax.while_loop(cond, body, init)
    xh, _ = xhat_p(c, a)
    div, cost = cost_of(c, xh)
    return NtfResult(c=c, a=a, iters=it, div=div, cost=cost)


def ten2mat(t: jnp.ndarray) -> jnp.ndarray:
    """(n, r, h) tensor -> (n, r*h) frontal-slice concatenation
    (src/ten2mat.m: columns of slice k occupy block k)."""
    n, r, h = t.shape
    return jnp.transpose(t, (0, 2, 1)).reshape(n, r * h)
