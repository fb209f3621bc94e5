"""NMF solver: JAX solver vs NumPy oracle equivalence, MU monotonicity,
masked-update equivalence to packed sub-problems, per-column batched solve
== sequential per-frame solves."""

import numpy as np
import jax.numpy as jnp
import pytest

from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_solve, snmf_h_solve_columns
from se_snmf_nat_tpu.oracle.sparse_nmf_np import sparse_nmf_np
from se_snmf_nat_tpu.utils.matlab_compat import matlab_v4_rand_matrix


def _data(m=40, r=8, n=25, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.random((m, r))
    h_true = rng.random((r, n))
    v = w_true @ h_true + 0.01 * rng.random((m, n))
    w0 = rng.random((m, r))
    h0 = rng.random((r, n))
    return v, w0, h0


@pytest.mark.parametrize("cf,beta", [("kl", 1.0), ("ed", 2.0), ("is", 0.0)])
def test_full_solve_matches_oracle(cf, beta):
    v, w0, h0 = _data()
    r = w0.shape[1]
    wn, hn, obj = sparse_nmf_np(v, cf=cf, sparsity=2.0, max_iter=30,
                                conv_eps=0.0, init_w=w0, init_h=h0)
    params = SnmfParams(beta=beta, sparsity=2.0, max_iter=30, conv_eps=0.0)
    res = snmf_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
                     jnp.ones(r, bool), jnp.ones(r, bool), params)
    np.testing.assert_allclose(np.asarray(res.w), wn, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.h), hn, rtol=1e-8, atol=1e-10)


def test_early_stop_matches_oracle():
    v, w0, h0 = _data(seed=3)
    r = w0.shape[1]
    wn, hn, obj = sparse_nmf_np(v, cf="kl", sparsity=5.0, max_iter=100,
                                conv_eps=1e-3, init_w=w0, init_h=h0)
    params = SnmfParams(beta=1.0, sparsity=5.0, max_iter=100, conv_eps=1e-3)
    res = snmf_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
                     jnp.ones(r, bool), jnp.ones(r, bool), params)
    assert int(res.iters) == len(obj["cost"])
    np.testing.assert_allclose(np.asarray(res.h), hn, rtol=1e-8, atol=1e-10)


def test_cost_monotone_nonincreasing():
    v, w0, h0 = _data(seed=4)
    _, _, obj = sparse_nmf_np(v, cf="kl", sparsity=1.0, max_iter=50,
                              conv_eps=0.0, init_w=w0, init_h=h0)
    c = obj["cost"]
    assert np.all(np.diff(c) <= 1e-9 * np.abs(c[:-1]) + 1e-12)


def test_h_only_solve_matches_oracle():
    """The per-frame activation solve (w fixed)."""
    v, w0, h0 = _data(seed=5)
    r = w0.shape[1]
    wn, hn, _ = sparse_nmf_np(v, cf="kl", sparsity=5.0, max_iter=40,
                              conv_eps=0.0, init_w=w0, init_h=h0,
                              w_update_ind=np.zeros(r, bool))
    params = SnmfParams(beta=1.0, sparsity=5.0, max_iter=40, conv_eps=0.0)
    res = snmf_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
                     jnp.zeros(r, bool), jnp.ones(r, bool), params,
                     update_w=False)
    np.testing.assert_allclose(np.asarray(res.h), hn, rtol=1e-9)


def test_w_only_masked_solve_equals_packed():
    """Zeroing masked-out columns/rows must equal the reference's dynamic
    column deletion (the online-adaptation solve)."""
    rng = np.random.default_rng(6)
    m, r_full, n = 30, 10, 20
    v = rng.random((m, n)) + 0.1
    w_full = rng.random((m, r_full)) + 0.1
    h_full = rng.random((r_full, n)) + 0.1
    keep = np.zeros(r_full, bool)
    keep[[1, 3, 4, 8]] = True

    # packed reference solve on the selected sub-dictionary
    wp, hp, _ = sparse_nmf_np(v, cf="kl", sparsity=5.0, max_iter=25,
                              conv_eps=0.0, init_w=w_full[:, keep],
                              init_h=h_full[keep],
                              h_update_ind=np.zeros(keep.sum(), bool))

    # masked fixed-shape solve
    params = SnmfParams(beta=1.0, sparsity=5.0, max_iter=25, conv_eps=0.0)
    w_masked = w_full * keep[None, :]
    h_masked = h_full * keep[:, None]
    res = snmf_solve(jnp.asarray(v), jnp.asarray(w_masked),
                     jnp.asarray(h_masked), jnp.asarray(keep),
                     jnp.zeros(r_full, bool), params, update_h=False)
    got = np.asarray(res.w)[:, keep]
    np.testing.assert_allclose(got, wp, rtol=1e-8, atol=1e-10)
    # masked-out columns remain exactly zero
    assert np.all(np.asarray(res.w)[:, ~keep] == 0.0)


def test_columnwise_batched_equals_sequential_per_frame():
    """snmf_h_solve_columns with per-column convergence must reproduce N
    independent m=1 solves (the streaming engine's per-frame calls)."""
    rng = np.random.default_rng(7)
    m, r, n = 50, 12, 9
    w = rng.random((m, r)) + 0.05
    v = np.abs(w @ (rng.random((r, n)) * 3)) + 0.01
    h0 = matlab_v4_rand_matrix(r, 1, seed=1)

    hs = []
    for j in range(n):
        _, hj, _ = sparse_nmf_np(v[:, j:j + 1], cf="kl", sparsity=5.0,
                                 max_iter=60, conv_eps=1e-3, init_w=w,
                                 init_h=h0.copy(),
                                 w_update_ind=np.zeros(r, bool))
        hs.append(hj[:, 0])
    want = np.stack(hs, axis=1)

    params = SnmfParams(beta=1.0, sparsity=5.0, max_iter=60, conv_eps=1e-3)
    res = snmf_h_solve_columns(jnp.asarray(v), jnp.asarray(w),
                               jnp.asarray(np.tile(h0, (1, n))), params)
    np.testing.assert_allclose(np.asarray(res.h), want, rtol=1e-8, atol=1e-12)


def test_matlab_v4_rand_reference_values():
    """Park–Miller minimal standard: x_{k+1} = 16807 x_k mod (2^31 - 1)."""
    u = matlab_v4_rand_matrix(3, 1, seed=1)[:, 0]
    m = 2**31 - 1
    x1 = 16807 % m
    x2 = (16807 * x1) % m
    x3 = (16807 * x2) % m
    np.testing.assert_allclose(u, [x1 / m, x2 / m, x3 / m], rtol=0)


@pytest.mark.parametrize("split,frac", [(32, 0.125), (2, 0.001), (16, 0.2)])
def test_split_solver_bitexact_vs_single_phase(split, frac):
    """Two-phase straggler compaction (SnmfParams.split_iter) returns
    BIT-IDENTICAL h to the single-phase loop: with fixed W every column's
    update sequence depends only on itself, so gathering the unconverged
    tail into a compact bucket changes scheduling, never trajectories.
    (2, 0.001) forces the overflow fallback (more active columns than the
    bucket), which must also be exact."""
    import dataclasses
    rng = np.random.default_rng(3)
    m, r, n = 120, 40, 64
    v = rng.gamma(0.6, 2.0, (m, n))
    w = rng.random((m, r))
    h0 = np.full((r, n), 0.5)
    p0 = SnmfParams(beta=1.0, sparsity=5.0, max_iter=60, conv_eps=1e-3)
    ps = dataclasses.replace(p0, split_iter=split, split_frac=frac)
    r0 = snmf_h_solve_columns(jnp.asarray(v), jnp.asarray(w),
                              jnp.asarray(h0), p0)
    r1 = snmf_h_solve_columns(jnp.asarray(v), jnp.asarray(w),
                              jnp.asarray(h0), ps)
    assert bool(jnp.all(r0.h == r1.h))
    assert int(r0.iters) == int(r1.iters)


def test_init_h_ones_matches_reference_surface():
    """sparse_nmf.m:135-138: p.init_h='ones' seeds H with ones.  The oracle
    accepts the string; the JAX solver takes the equivalent explicit h0 and
    must match it bit-for-bit at x64."""
    v, w0, _ = _data(seed=6)
    r = w0.shape[1]
    wn, hn, _ = sparse_nmf_np(v, cf="kl", sparsity=2.0, max_iter=25,
                              conv_eps=0.0, init_w=w0, init_h="ones")
    params = SnmfParams(beta=1.0, sparsity=2.0, max_iter=25, conv_eps=0.0)
    res = snmf_solve(jnp.asarray(v), jnp.asarray(w0),
                     jnp.ones((r, v.shape[1])),
                     jnp.ones(r, bool), jnp.ones(r, bool), params)
    np.testing.assert_allclose(np.asarray(res.w), wn, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.h), hn, rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError):
        sparse_nmf_np(v, init_w=w0, init_h="zeros")


@pytest.mark.parametrize("conv_eps", [0.0, 1e-3])
def test_objective_trace_matches_oracle(conv_eps):
    """snmf_solve_traced reproduces the reference's objective.div/cost
    arrays (sparse_nmf.m:260-270) and snmf_solve's final factors."""
    from se_snmf_nat_tpu.nmf.solver import snmf_solve_traced

    v, w0, h0 = _data(seed=7)
    r = w0.shape[1]
    _, hn, obj = sparse_nmf_np(v, cf="kl", sparsity=3.0, max_iter=40,
                               conv_eps=conv_eps, init_w=w0, init_h=h0)
    params = SnmfParams(beta=1.0, sparsity=3.0, max_iter=40,
                        conv_eps=conv_eps)
    args = (jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
            jnp.ones(r, bool), jnp.ones(r, bool), params)
    res_t, trace = snmf_solve_traced(*args)
    res = snmf_solve(*args)
    it = int(res_t.iters)
    assert it == int(res.iters) == len(obj["cost"])
    np.testing.assert_allclose(np.asarray(res_t.h), np.asarray(res.h),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(res_t.h), hn,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(trace["div"])[:it], obj["div"],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(trace["cost"])[:it], obj["cost"],
                               rtol=1e-8, atol=1e-10)
    assert not np.any(np.asarray(trace["cost"])[it:])


def test_oracle_display_prints_objective(capsys):
    v, w0, h0 = _data(seed=8)
    sparse_nmf_np(v, cf="kl", sparsity=1.0, max_iter=3, conv_eps=0.0,
                  init_w=w0, init_h=h0, display=True)
    out = capsys.readouterr().out
    assert out.count("iteration") == 3 and "div =" in out
