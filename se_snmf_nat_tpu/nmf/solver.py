"""Beta-divergence sparse-NMF multiplicative-update solvers (JAX).

Re-design of the reference solver family (src/sparse_nmf.m — the
Le Roux/Hershey/Weninger TR2015-023 formulation with L1 sparsity on H and
updates in L2-normalized basis space; also covers the roles of
src/sparse_nmf_GPU.m).  Three entry points:

* ``snmf_solve``           — one factorization (training, online adaptation).
                             Data-dependent early stopping runs inside a
                             ``lax.while_loop`` so the whole solve jits.
* ``snmf_h_solve_columns`` — activation-only solve where every column of V is
                             treated as an INDEPENDENT problem with its own
                             convergence test.  With fixed W the KL/ED/beta
                             H-update decouples per column, so this is
                             numerically identical to the reference's
                             per-frame m=1 solves (engine :140-154) while
                             batching thousands of frames into large
                             GEMMs.
* masked updates           — the reference packs sub-dictionaries by deleting
                             columns (dynamic shapes,
                             bnmf_sep_event_RT_IS16.m:292,302-304,322-325).
                             Here selection masks zero out excluded columns'
                             basis vectors and activation rows instead; the
                             excluded columns contribute exactly zero to
                             W@H and to every sum the updates use, so the
                             fixed-shape masked solve reproduces the packed
                             solve bit-for-bit in exact arithmetic.

Update-rule shapes (beta=1/KL shown; m×n data V, m×r basis W, r×n acts H):
    H:  H <- H .* (Wᵀ(V/Λ)) ./ (1ᵀW + sparsity)
    W:  W <- W .* [(V/Λ)Hᵀ + (1ᵀ(WᵀW diag-free…))] — tangent-space corrected
        so columns stay on the unit sphere, then re-normalized.
Λ = max(WH, flr) throughout; cost = beta-divergence + Σ sparsity.*H.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

FLR = 1e-9

# Fully UNROLLING the fixed-iteration (conv_eps<=0) H-solve loops instead
# of lax.while_loop lost end to end on the previous accelerator; not
# measured on the H100, where a while_loop trip also costs a host-visible
# predicate, so it is worth measuring again.


@dataclasses.dataclass(frozen=True)
class SnmfParams:
    beta: float = 1.0          # 0: IS, 1: KL, 2: ED, else general
    sparsity: float = 5.0
    max_iter: int = 100
    conv_eps: float = 1e-3     # 0 disables early stopping
    flr: float = FLR
    precision: str = "highest"  # matmul precision for the MU GEMMs
    # two-phase straggler compaction for snmf_h_solve_columns (0 = off):
    # run all columns for split_iter trips, then gather the still-active
    # columns (typically the ~1% whose relative-cost test oscillates past
    # the p95 freeze iteration — median freeze 25, p95 31 at the
    # production KL config) into a split_frac-sized bucket and finish only
    # those.  Column updates depend on no other column, so results are
    # BIT-IDENTICAL to the single-phase loop (tests/test_nmf.py).
    # Status: validated option, default OFF — splitting the fused
    # while_loop into three adds round trips of the working set; the
    # shipped straggler answer is the block plan's iteration cap
    # (stream/block_adaptive.py iter_cap).  Not measured on the H100.
    split_iter: int = 0
    split_frac: float = 0.125

    @property
    def lax_precision(self):
        return {
            "highest": lax.Precision.HIGHEST,
            "high": lax.Precision.HIGH,
            "default": lax.Precision.DEFAULT,
        }[self.precision]


def normalize_columns(w: jnp.ndarray, flr_guard: bool = True) -> tuple[jnp.ndarray, jnp.ndarray]:
    """L2-normalize columns; zero columns (masked-out slots) stay zero."""
    wn = jnp.sqrt(jnp.sum(w * w, axis=0))
    safe = jnp.where(wn > 0.0, wn, 1.0) if flr_guard else wn
    return w / safe[None, :], wn


def _dot(a, b, prec):
    return jnp.matmul(a, b, precision=prec)


def _divergence(v, lamb, beta: float):
    if beta == 1.0:
        return jnp.sum(v * jnp.log(v / lamb) - v + lamb)
    if beta == 2.0:
        return jnp.sum((v - lamb) ** 2)
    if beta == 0.0:
        return jnp.sum(v / lamb - jnp.log(v / lamb) - 1.0)
    return jnp.sum(
        v ** beta + (beta - 1.0) * lamb ** beta
        - beta * v * lamb ** (beta - 1.0)
    ) / (beta * (beta - 1.0))


def _h_step(v, w, h, lamb, sparsity, beta: float, flr, h_mask, prec):
    """One multiplicative H update restricted to h_mask rows."""
    wm = w * h_mask[None, :]          # only masked columns drive the update
    if beta == 1.0:
        dph = jnp.sum(wm, axis=0)[:, None] + sparsity
        dph = jnp.maximum(dph, flr)
        dmh = _dot(wm.T, v / lamb, prec)
    elif beta == 2.0:
        dph = _dot(wm.T, lamb, prec) + sparsity
        dph = jnp.maximum(dph, flr)
        dmh = _dot(wm.T, v, prec)
    else:
        dph = _dot(wm.T, lamb ** (beta - 1.0), prec) + sparsity
        dph = jnp.maximum(dph, flr)
        dmh = _dot(wm.T, v * lamb ** (beta - 2.0), prec)
    h_new = h * dmh / dph
    return jnp.where(h_mask[:, None], h_new, h)


def _w_step(v, w, h, lamb, beta: float, flr, w_mask, prec):
    """One multiplicative W update (tangent-space corrected, unit columns)
    restricted to w_mask columns.  h rows outside w_mask are excluded from
    every sum, matching the reference's h(w_ind,:) sub-selection."""
    hm = h * w_mask[:, None]
    sumh = jnp.sum(hm, axis=1)        # (r,)
    if beta == 1.0:
        c = _dot(v / lamb, hm.T, prec)             # (m, r)
        corr_p = jnp.sum(c * w, axis=0)            # (r,)
        dpw = sumh[None, :] + corr_p[None, :] * w
        dpw = jnp.maximum(dpw, flr)
        corr_m = sumh * jnp.sum(w, axis=0)
        dmw = c + corr_m[None, :] * w
    elif beta == 2.0:
        lh = _dot(lamb, hm.T, prec)
        vh = _dot(v, hm.T, prec)
        dpw = lh + jnp.sum(vh * w, axis=0)[None, :] * w
        dpw = jnp.maximum(dpw, flr)
        dmw = vh + jnp.sum(lh * w, axis=0)[None, :] * w
    else:
        lb1 = lamb ** (beta - 1.0)
        vb2 = v * lamb ** (beta - 2.0)
        lh = _dot(lb1, hm.T, prec)
        vh = _dot(vb2, hm.T, prec)
        dpw = lh + jnp.sum(vh * w, axis=0)[None, :] * w
        dpw = jnp.maximum(dpw, flr)
        dmw = vh + jnp.sum(lh * w, axis=0)[None, :] * w
    w_new = w * dmw / dpw
    w_new = jnp.where(w_mask[None, :], w_new, w)
    w_new, _ = normalize_columns(w_new)
    return w_new


class SnmfResult(NamedTuple):
    w: jnp.ndarray
    h: jnp.ndarray
    iters: jnp.ndarray   # iterations actually run (scalar int32)
    div: jnp.ndarray     # final divergence
    cost: jnp.ndarray    # final cost (div + sparsity penalty)


@partial(jax.jit, static_argnames=("params", "update_w", "update_h",
                                   "need_stats"))
def snmf_solve(v: jnp.ndarray, w0: jnp.ndarray, h0: jnp.ndarray,
               w_mask: jnp.ndarray, h_mask: jnp.ndarray,
               params: SnmfParams, update_w: bool = True,
               update_h: bool = True,
               active: jnp.ndarray | None = None,
               need_stats: bool = True) -> SnmfResult:
    """Full sparse-NMF solve with reference-equivalent semantics.

    v: (m, n) nonnegative data;  w0: (m, r);  h0: (r, n).
    w_mask / h_mask: (r,) bool — which columns/rows update (the reference's
    w_update_ind / h_update_ind).  update_w/update_h are the static switches
    (sum(ind) > 0 in the reference); pass False to skip a phase entirely.

    Entry behavior matches sparse_nmf.m:157-169: v floored at flr, W columns
    L2-normalized with H rescaled by the norms, Λ floored.

    active: optional traced bool scalar; when False the MU loop runs zero
    iterations (result = entry-normalized factors).  Callers whose result
    is discarded on inactive lanes (the engine's trigger-gated refit under
    vmap, where lax.cond batches to a select and would otherwise run the
    full solve for every lane every frame) use this to let the vmapped
    while_loop converge in max-over-TRIGGERED-lanes iterations.
    """
    prec = params.lax_precision
    flr = jnp.asarray(params.flr, v.dtype)
    sparsity = jnp.asarray(params.sparsity, v.dtype)
    beta = params.beta

    v = jnp.maximum(v, flr)
    w, wn = normalize_columns(w0)
    h = h0 * wn[:, None]
    lamb = jnp.maximum(_dot(w, h, prec), flr)

    def cost_of(v, lamb, h):
        div = _divergence(v, lamb, beta)
        return div, div + jnp.sum(sparsity * h)

    def body(carry):
        it, w, h, lamb, last_cost, _ = carry
        if update_h:
            h = _h_step(v, w, h, lamb, sparsity, beta, flr, h_mask, prec)
            lamb = jnp.maximum(_dot(w, h, prec), flr)
        if update_w:
            w = _w_step(v, w, h, lamb, beta, flr, w_mask, prec)
            lamb = jnp.maximum(_dot(w, h, prec), flr)
        if params.conv_eps > 0:
            _, cost = cost_of(v, lamb, h)
            rel = jnp.abs(cost - last_cost) / jnp.abs(last_cost)
            done = jnp.logical_and(it > 0, rel < params.conv_eps)
        else:
            # fixed-iteration mode: the cost is pure convergence-test
            # machinery, and it is NOT free — the KL term's log alone is a
            # full elementwise pass over (m, n) every trip.  Skip it; the
            # final div/cost are computed once after the loop.
            cost, done = last_cost, jnp.asarray(False)
        return it + 1, w, h, lamb, cost, done

    def cond(carry):
        it, *_, done = carry
        run = jnp.logical_and(it < params.max_iter, jnp.logical_not(done))
        if active is not None:
            run = jnp.logical_and(run, active)
        return run

    init = (jnp.asarray(0, jnp.int32), w, h, lamb,
            jnp.asarray(jnp.inf, v.dtype), jnp.asarray(False))
    it, w, h, lamb, cost, _ = lax.while_loop(cond, body, init)
    if not need_stats:
        # factor-only callers (the engines' H-solves and refits use only
        # res.h / res.w): skip the final divergence — a full (m, n)
        # elementwise pass incl. a log, pure reporting.
        zero = jnp.zeros((), v.dtype)
        return SnmfResult(w=w, h=h, iters=it, div=zero, cost=zero)
    div = _divergence(v, lamb, beta)
    if params.conv_eps <= 0:        # cost skipped in-loop; compute it once
        cost = div + jnp.sum(sparsity * h)
    return SnmfResult(w=w, h=h, iters=it, div=div, cost=cost)


@partial(jax.jit, static_argnames=("params", "update_w", "update_h"))
def snmf_solve_traced(v: jnp.ndarray, w0: jnp.ndarray, h0: jnp.ndarray,
                      w_mask: jnp.ndarray, h_mask: jnp.ndarray,
                      params: SnmfParams, update_w: bool = True,
                      update_h: bool = True
                      ) -> tuple[SnmfResult, dict]:
    """``snmf_solve`` with the reference's per-iteration objective trace
    (sparse_nmf.m:260-270 ``objective.div/cost``) — an opt-in diagnostic
    surface, NOT a production path (the cost pass it records each trip is
    the exact overhead the fixed-iteration plans skip).

    Returns ``(result, {"div": (max_iter,), "cost": (max_iter,)})`` where
    entries past ``result.iters`` are zero — truncate host-side with
    ``objective["div"][:int(result.iters)]``.  Runs the SAME update
    sequence as ``snmf_solve`` (a ``lax.scan`` whose lanes freeze after
    the relative-cost stop fires instead of a while_loop), so the final
    factors are identical; gated vs the oracle histories in
    tests/test_nmf.py.
    """
    prec = params.lax_precision
    flr = jnp.asarray(params.flr, v.dtype)
    sparsity = jnp.asarray(params.sparsity, v.dtype)
    beta = params.beta

    v = jnp.maximum(v, flr)
    w, wn = normalize_columns(w0)
    h = h0 * wn[:, None]
    lamb = jnp.maximum(_dot(w, h, prec), flr)

    def body(carry, _):
        it, w, h, lamb, last_cost, done = carry
        run = jnp.logical_not(done)
        w2, h2, lamb2 = w, h, lamb
        if update_h:
            h2 = _h_step(v, w2, h2, lamb2, sparsity, beta, flr, h_mask,
                         prec)
            lamb2 = jnp.maximum(_dot(w2, h2, prec), flr)
        if update_w:
            w2 = _w_step(v, w2, h2, lamb2, beta, flr, w_mask, prec)
            lamb2 = jnp.maximum(_dot(w2, h2, prec), flr)
        div = _divergence(v, lamb2, beta)
        cost = div + jnp.sum(sparsity * h2)
        rel = jnp.abs(cost - last_cost) / jnp.abs(last_cost)
        if params.conv_eps > 0:
            newly_done = jnp.logical_and(it > 0, rel < params.conv_eps)
        else:
            newly_done = jnp.asarray(False)
        sel = lambda a, b: jax.tree.map(
            lambda x, y: jnp.where(run, x, y), a, b)
        w, h, lamb = sel((w2, h2, lamb2), (w, h, lamb))
        zero = jnp.zeros((), v.dtype)
        rec = (jnp.where(run, div, zero), jnp.where(run, cost, zero))
        carry = (it + run.astype(jnp.int32), w, h, lamb,
                 jnp.where(run, cost, last_cost),
                 jnp.logical_or(done, jnp.logical_and(run, newly_done)))
        return carry, rec

    init = (jnp.asarray(0, jnp.int32), w, h, lamb,
            jnp.asarray(jnp.inf, v.dtype), jnp.asarray(False))
    (it, w, h, lamb, cost, _), (divs, costs) = lax.scan(
        body, init, None, length=params.max_iter)
    div = _divergence(v, lamb, beta)
    res = SnmfResult(w=w, h=h, iters=it, div=div,
                     cost=div + jnp.sum(sparsity * h)
                     if params.conv_eps <= 0 else cost)
    return res, {"div": divs, "cost": costs}


@partial(jax.jit, static_argnames=("params",))
def snmf_h_solve_columns_split(v: jnp.ndarray, w_shared: jnp.ndarray,
                               w_head: jnp.ndarray, h0_shared: jnp.ndarray,
                               h0_head: jnp.ndarray, params: SnmfParams
                               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``snmf_h_solve_columns`` with the basis split into a SHARED part and
    a per-problem HEAD part — the wide-GEMM form of the block plan's
    H-solve (stream/block_adaptive.py ``split_solve``).

    Motivation: under ``vmap`` over a B-utterance batch, the fused solve's
    GEMMs are per-lane batched matmuls with only N = K block columns,
    narrow for a matrix unit.  But only the ADAPTED head columns
    (``state.b_d_head``, r_a=50 of r=200) differ between lanes — the
    speech basis and the noise tail are lane-invariant.  Passing them as
    an unbatched ``w_shared`` lets vmap emit ONE unbatched-lhs contraction
    with N = B*K columns for 75% of the FLOPs; only
    the r_a head GEMMs stay per-lane batched.

    Exactness: dmh rows split bit-exactly (row i of W^T u depends only on
    column i of W); Lambda's contraction splits into two partial sums, so
    f32 results can differ from the fused solve only in that sum's
    rounding (x64 agreement is gated at 1e-12 in tests/test_nmf.py, and
    the golden-wav gates cover the shipped f32 plan).

    v: (m, n); w_shared: (m, r_s); w_head: (m, r_h);
    h0_shared: (r_s, n); h0_head: (r_h, n).  Returns (h_shared, h_head).
    """
    prec = params.lax_precision
    flr = jnp.asarray(params.flr, v.dtype)
    sparsity = jnp.asarray(params.sparsity, v.dtype)
    beta = params.beta

    v = jnp.maximum(v, flr)
    ws, wns = normalize_columns(w_shared)
    wh, wnh = normalize_columns(w_head)
    hs = h0_shared * wns[:, None]
    hh = h0_head * wnh[:, None]

    def lamb_of(hs, hh):
        return jnp.maximum(_dot(ws, hs, prec) + _dot(wh, hh, prec), flr)

    lamb = lamb_of(hs, hh)
    n = v.shape[1]

    if beta == 1.0:
        dph_s = jnp.maximum(jnp.sum(ws, axis=0)[:, None] + sparsity, flr)
        dph_h = jnp.maximum(jnp.sum(wh, axis=0)[:, None] + sparsity, flr)

    def col_cost(lamb, hs, hh):
        div = (
            jnp.sum(v * jnp.log(v / lamb) - v + lamb, axis=0)
            if beta == 1.0 else
            jnp.sum((v - lamb) ** 2, axis=0) if beta == 2.0 else
            jnp.sum(v / lamb - jnp.log(v / lamb) - 1.0, axis=0)
            if beta == 0.0
            else jnp.sum(v ** beta + (beta - 1.0) * lamb ** beta
                         - beta * v * lamb ** (beta - 1.0), axis=0)
            / (beta * (beta - 1.0))
        )
        return div + sparsity * (jnp.sum(hs, axis=0) + jnp.sum(hh, axis=0))

    def body(carry):
        it, hs, hh, lamb, last_cost, active = carry
        if beta == 1.0:
            u = v / lamb
            hs_new = hs * _dot(ws.T, u, prec) / dph_s
            hh_new = hh * _dot(wh.T, u, prec) / dph_h
        elif beta == 2.0:
            dph_sl = jnp.maximum(_dot(ws.T, lamb, prec) + sparsity, flr)
            dph_hl = jnp.maximum(_dot(wh.T, lamb, prec) + sparsity, flr)
            hs_new = hs * _dot(ws.T, v, prec) / dph_sl
            hh_new = hh * _dot(wh.T, v, prec) / dph_hl
        else:
            lb1 = lamb ** (beta - 1.0)
            u = v * lamb ** (beta - 2.0)
            dph_sl = jnp.maximum(_dot(ws.T, lb1, prec) + sparsity, flr)
            dph_hl = jnp.maximum(_dot(wh.T, lb1, prec) + sparsity, flr)
            hs_new = hs * _dot(ws.T, u, prec) / dph_sl
            hh_new = hh * _dot(wh.T, u, prec) / dph_hl
        hs = jnp.where(active[None, :], hs_new, hs)
        hh = jnp.where(active[None, :], hh_new, hh)
        lamb = lamb_of(hs, hh)
        if params.conv_eps > 0:
            cost = col_cost(lamb, hs, hh)
            rel = jnp.abs(cost - last_cost) / jnp.abs(last_cost)
            newly_done = jnp.logical_and(it > 0, rel < params.conv_eps)
            active = jnp.logical_and(active, jnp.logical_not(newly_done))
        else:
            cost = last_cost            # fixed-iteration mode: skip (see
        return it + 1, hs, hh, lamb, cost, active   # snmf_h_solve_columns)

    def cond(carry):
        it, _, _, _, _, active = carry
        return jnp.logical_and(it < params.max_iter, jnp.any(active))

    init = (jnp.asarray(0, jnp.int32), hs, hh, lamb,
            jnp.full((n,), jnp.inf, v.dtype), jnp.ones((n,), bool))
    _, hs, hh, _, _, _ = lax.while_loop(cond, body, init)
    return hs, hh


@partial(jax.jit, static_argnames=("params",))
def snmf_h_solve_columns(v: jnp.ndarray, w: jnp.ndarray, h0: jnp.ndarray,
                         params: SnmfParams) -> SnmfResult:
    """Activation solve treating every column as an independent problem.

    Reproduces N separate ``sparse_nmf(v[:, j:j+1], p)`` H-only calls (the
    per-frame solves of the streaming engine) in ONE batched loop: each
    column carries its own cost/convergence state and freezes when its own
    relative-cost criterion fires, so iteration counts — and therefore
    results — match the sequential reference exactly.

    v: (m, n);  w: (m, r) — used as given after column normalization;
    h0: (r, n) initial activations (pre-rescale, as MATLAB rand init).
    """
    prec = params.lax_precision
    flr = jnp.asarray(params.flr, v.dtype)
    sparsity = jnp.asarray(params.sparsity, v.dtype)
    beta = params.beta

    v = jnp.maximum(v, flr)
    w, wn = normalize_columns(w)
    h = h0 * wn[:, None]
    lamb = jnp.maximum(_dot(w, h, prec), flr)
    n = v.shape[1]

    if beta == 1.0:
        dph_base = jnp.sum(w, axis=0)[:, None] + sparsity  # constant for KL
        dph_base = jnp.maximum(dph_base, flr)

    def run_phase(v_p, h_p, lamb_p, cost_p, active_p, it0, it_hi: int):
        """One while_loop over columns of v_p; w (and the KL dph_base) are
        shared across phases, so phase boundaries never change a column's
        update sequence."""

        def col_cost(lamb, h):
            div = (
                jnp.sum(v_p * jnp.log(v_p / lamb) - v_p + lamb, axis=0)
                if beta == 1.0 else
                jnp.sum((v_p - lamb) ** 2, axis=0) if beta == 2.0 else
                jnp.sum(v_p / lamb - jnp.log(v_p / lamb) - 1.0, axis=0)
                if beta == 0.0
                else jnp.sum(v_p ** beta + (beta - 1.0) * lamb ** beta
                             - beta * v_p * lamb ** (beta - 1.0), axis=0)
                / (beta * (beta - 1.0))
            )
            return div, div + jnp.sum(sparsity * h, axis=0)

        def body(carry):
            it, h, lamb, last_cost, active = carry
            if beta == 1.0:
                dmh = _dot(w.T, v_p / lamb, prec)
                h_new = h * dmh / dph_base
            elif beta == 2.0:
                dph = jnp.maximum(_dot(w.T, lamb, prec) + sparsity, flr)
                h_new = h * _dot(w.T, v_p, prec) / dph
            else:
                dph = jnp.maximum(
                    _dot(w.T, lamb ** (beta - 1.0), prec) + sparsity, flr)
                h_new = h * _dot(w.T, v_p * lamb ** (beta - 2.0), prec) / dph
            h = jnp.where(active[None, :], h_new, h)
            lamb = jnp.maximum(_dot(w, h, prec), flr)
            if params.conv_eps > 0:
                _, cost = col_cost(lamb, h)
                rel = jnp.abs(cost - last_cost) / jnp.abs(last_cost)
                newly_done = jnp.logical_and(it > 0, rel < params.conv_eps)
                active = jnp.logical_and(active, jnp.logical_not(newly_done))
            else:
                # fixed-iteration mode: the per-column cost exists only to
                # drive early stopping — skipping it drops a full (m, n)
                # elementwise pass incl. a log per trip; final div/cost
                # computed post-loop
                cost = last_cost
            return it + 1, h, lamb, cost, active

        def cond(carry):
            it, _, _, _, active = carry
            return jnp.logical_and(it < it_hi, jnp.any(active))

        init = (jnp.asarray(it0, jnp.int32), h_p, lamb_p, cost_p, active_p)
        return lax.while_loop(cond, body, init)

    cost0 = jnp.full((n,), jnp.inf, v.dtype)
    act0 = jnp.ones((n,), bool)
    split = params.split_iter if params.conv_eps > 0 else 0
    if split and 0 < split < params.max_iter and n >= 32:
        it, h, lamb, cost, active = run_phase(v, h, lamb, cost0, act0,
                                              0, split)
        n2 = min(n, max(8, int(round(n * params.split_frac))))
        n_act = jnp.sum(active, dtype=jnp.int32)
        overflow = n_act > n2
        # stable argsort puts active columns first in original order
        order = jnp.argsort(jnp.logical_not(active), stable=True)
        idx = order[:n2]
        act_c = jnp.logical_and(active[idx], jnp.logical_not(overflow))
        it2, h_c, lamb_c, cost_c, _ = run_phase(
            v[:, idx], h[:, idx], lamb[:, idx], cost[idx], act_c,
            it, params.max_iter)
        h = h.at[:, idx].set(h_c)
        lamb = lamb.at[:, idx].set(lamb_c)
        cost = cost.at[idx].set(cost_c)
        # overflow fallback: if more than n2 columns were still active, the
        # compacted loop ran zero trips (act_c forced False) and this
        # full-width loop finishes everything; otherwise it runs zero trips
        act_f = jnp.logical_and(active, overflow)
        it3, h, lamb, cost, _ = run_phase(v, h, lamb, cost, act_f,
                                          it, params.max_iter)
        it = jnp.maximum(it2, it3)
    else:
        it, h, lamb, cost, _ = run_phase(v, h, lamb, cost0, act0,
                                         0, params.max_iter)
    div = _divergence(v, lamb, beta)
    cost_total = jnp.sum(cost) if params.conv_eps > 0 \
        else div + jnp.sum(sparsity * h)
    return SnmfResult(w=w, h=h, iters=it, div=div, cost=cost_total)
