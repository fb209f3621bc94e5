"""Variational-Bayes NMF core for the Mohammadiha TASLP-2013 baseline.

The reference dispatches its third algorithm, BNMF, to an external
``@NMF`` class that is absent from its own repo
(/root/reference/proc_BNMF_nmoh.m:3 adds src/BNMF_nmoh/ which does not
exist), so nothing can be ported — this is a fresh implementation of the
underlying inference (Cemgil 2009, "Bayesian inference for nonnegative
matrix factorisation models"; Mohammadiha/Smaragdis/Leijon TASLP 2013
builds its enhancer on it).  Everything the reference wrapper DOES pin
down (frame sizes, spectrogram scale, rank/prior constants, the online
noise-buffer scheme, the WADA SNR tracker) is reproduced exactly in
bnmf/enhance.py with file:line citations.

Model (KL/Poisson compound):
    X_ft = sum_k Z_fkt,   Z_fkt ~ Po(W_fk H_kt)
    W_fk ~ Gamma(shape a0_W, scale b0_W/a0_W)   (mean b0_W)
    H_kt ~ Gamma(shape a0_H, scale b0_H/a0_H)

Variational posteriors are Gamma in shape/scale form, q(W_fk) =
Gamma(aW, sW), q(H_kt) = Gamma(aH, sH).  With LW = exp(psi(aW))*sW
(= exp E[log W]) and EW = aW*sW (posterior mean), one block update is

    Lam  = LW @ LH
    SH   = LH * (LW^T (X / Lam))        # sum_f E[Z_fkt]
    aH   = a0_H + SH
    sH   = 1 / (a0_H/b0_H + sum_f EW)   # rate accumulates basis mass

and symmetrically for W with SW = LW * ((X/Lam) @ LH^T) and the
sum_t EH rate.  Alternating the H and W blocks (each paired with the
implicit optimal q(Z)) is coordinate ascent on the ELBO, so the bound is
monotone non-decreasing — the correctness oracle the tests gate on.

Device mapping: every update is two GEMM-class contractions plus
elementwise work on (F, K)/(K, T) panels — the same GEMM shape class
as the sparse-NMF MU loop — iterated under ``lax.scan`` with static
iteration counts (no data-dependent control flow).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.utils.special import digamma

_FLR = 1e-30


class GammaPost(NamedTuple):
    """Gamma posterior in shape/scale form (elementwise arrays)."""
    shape: jnp.ndarray
    scale: jnp.ndarray

    @property
    def mean(self):
        return self.shape * self.scale

    def explog(self, xp=jnp):
        """exp(E[log theta]) = exp(psi(shape)) * scale."""
        return xp.exp(digamma(self.shape, xp=xp)) * self.scale


def init_train(x: np.ndarray, k: int, seed: int = 0):
    """Deterministic host-side initialization for vb_train.

    Prior means are set from the data scale so E[Lam] matches mean(X)
    (b0_W = 1, b0_H = mean(X)/k); the posterior means start at the prior
    means perturbed by seeded uniform noise for symmetry breaking (the
    reference class's init is unrecoverable — documented deviation).
    Returns (w0, h0, b0_w, b0_h) as float64 numpy arrays.
    """
    f, t = x.shape
    rng = np.random.RandomState(seed)
    b0_w = 1.0
    b0_h = max(float(np.mean(x)), 1e-6) / k
    w0 = b0_w * (0.5 + rng.rand(f, k))
    h0 = b0_h * (0.5 + rng.rand(k, t))
    return w0, h0, b0_w, b0_h


def _h_block(x, lw, ew_colsum, h: GammaPost, a0_h, inv_b0_rate, xp=jnp):
    """One H block update given fixed W statistics.

    ``inv_b0_rate`` is the prior rate a0_H/b0_H (elementwise or scalar);
    ``ew_colsum`` is sum_f E[W] per component, shape (k, 1)."""
    lh = h.explog(xp=xp)
    lam = xp.maximum(lw @ lh, _FLR)
    sh = lh * (lw.T @ (x / lam))
    shape = xp.maximum(a0_h + sh, 1e-12)
    scale = xp.broadcast_to(1.0 / (inv_b0_rate + ew_colsum), shape.shape)
    return GammaPost(shape, scale)


def _w_block(x, lh, eh_rowsum, w: GammaPost, a0_w, inv_b0_rate, xp=jnp):
    """One W block update given fixed H statistics; ``eh_rowsum`` is
    sum_t E[H] per component, shape (1, k)."""
    lw = w.explog(xp=xp)
    lam = xp.maximum(lw @ lh, _FLR)
    sw = lw * ((x / lam) @ lh.T)
    shape = xp.maximum(a0_w + sw, 1e-12)
    scale = xp.broadcast_to(1.0 / (inv_b0_rate + eh_rowsum), shape.shape)
    return GammaPost(shape, scale)


def _gamma_kl(q: GammaPost, shape0, mean0, xp=jnp, gammaln=None):
    """KL(q || Gamma(shape0, mean0/shape0)), summed over elements."""
    if gammaln is None:
        gammaln = jax.scipy.special.gammaln
    scale0 = mean0 / shape0
    t = ((q.shape - shape0) * digamma(q.shape, xp=xp)
         - gammaln(q.shape) + gammaln(shape0)
         + shape0 * (xp.log(scale0) - xp.log(q.scale))
         + q.shape * (q.scale - scale0) / scale0)
    return xp.sum(t)


def elbo(x, w: GammaPost, h: GammaPost, a0_w, b0_w, a0_h, b0_h,
         xp=jnp, gammaln=None):
    """Variational lower bound (up to the constant -sum log(x!), which is
    omitted: it does not depend on the posteriors)."""
    if gammaln is None:
        gammaln = jax.scipy.special.gammaln
    lw, lh = w.explog(xp=xp), h.explog(xp=xp)
    lam = xp.maximum(lw @ lh, _FLR)
    pois = xp.sum(x * xp.log(lam) - w.mean @ h.mean)
    return (pois - _gamma_kl(w, a0_w, b0_w, xp=xp, gammaln=gammaln)
            - _gamma_kl(h, a0_h, b0_h, xp=xp, gammaln=gammaln))


@partial(jax.jit, static_argnames=("n_iter", "trace_bound"))
def vb_train(x: jnp.ndarray, w0: jnp.ndarray, h0: jnp.ndarray,
             b0_w, b0_h, a_w: float = 1.0, a_h: float = 1.0,
             n_iter: int = 100, trace_bound: bool = False):
    """Full VB training of both factors on a spectrogram ``x`` (F, T).

    Posterior means start at (w0, h0) with unit-shape pseudo-posteriors.
    Returns (w_post, h_post, bound_trace) — bound_trace is zeros unless
    ``trace_bound`` (the bound costs two extra GEMMs per iteration).
    """
    x = jnp.maximum(x, _FLR)
    w = GammaPost(jnp.full_like(w0, a_w), w0 / a_w)
    h = GammaPost(jnp.full_like(h0, a_h), h0 / a_h)
    rw = a_w / b0_w
    rh = a_h / b0_h

    def step(carry, _):
        w, h = carry
        lw = w.explog()
        h = _h_block(x, lw, jnp.sum(w.mean, 0)[:, None], h, a_h, rh)
        lh = h.explog()
        w = _w_block(x, lh, jnp.sum(h.mean, 1)[None, :], w, a_w, rw)
        b = elbo(x, w, h, a_w, b0_w, a_h, b0_h) if trace_bound else 0.0
        return (w, h), b

    (w, h), trace = jax.lax.scan(step, (w, h), None, length=n_iter)
    return w, h, trace


def clamp_min_shape(post: GammaPost, min_shape: float) -> GammaPost:
    """Raise the posterior shape to >= min_shape at constant mean — the
    reference's adjust_ShapeparamBasis(200) (proc_BNMF_nmoh.m:104):
    reduces posterior variance of the online noise basis so single frames
    cannot swing it."""
    mean = post.mean
    shape = jnp.maximum(post.shape, min_shape)
    return GammaPost(shape, mean / shape)


@partial(jax.jit, static_argnames=("n_iter",))
def vb_h_infer(y: jnp.ndarray, w: GammaPost, u: jnp.ndarray,
               phi: jnp.ndarray, n_iter: int = 25) -> GammaPost:
    """Activation inference with the basis posterior FIXED.

    y: (F, T) columns to explain (T may be 1 for a single frame).
    u: (K, T) prior means; phi: (K, 1) prior shapes — phi=0 is the
    improper vague prior the wrapper sets for speech (UserData [0
    a_noise], proc_BNMF_nmoh.m:110), under which shape = sum E[Z] and the
    prior mean drops out; phi=a_noise=100 pins noise activations near
    their smoothed history (TASLP 2013 §III.C).
    """
    y = jnp.maximum(y, _FLR)
    lw = w.explog()
    ew_colsum = jnp.sum(w.mean, 0)[:, None]
    # prior rate phi/u; where phi == 0 the prior contributes nothing
    inv_rate = jnp.where(phi > 0.0, phi / jnp.maximum(u, _FLR), 0.0)
    h = GammaPost(jnp.maximum(phi, 1.0) * jnp.ones_like(u),
                  jnp.maximum(u, _FLR) / jnp.maximum(phi, 1.0))

    def step(h, _):
        return _h_block(y, lw, ew_colsum, h, phi, inv_rate), None

    h, _ = jax.lax.scan(step, h, None, length=n_iter)
    return h
