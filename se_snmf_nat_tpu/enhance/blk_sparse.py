"""Local block-sparsity statistic Q — vectorized.

Re-design of src/blk_sparse.m.  The reference loops over ~150 frequency
blocks per frame, reshaping a (P_len_k, P_len_l) window and computing the
Hoyer sparsity of each.  Here the window L1/L2 sums come from cumulative
sums over per-bin row statistics (O(F) instead of O(F * P_len_k)), and all
block centers evaluate in parallel.

Reference quirk preserved: with blk_gap >= 3 the "decision-directed"
smoothing term Q(k-1) always reads the untouched 0.1 initialization (the
previous block's writes stop at k-gap+1+ (gap-1)/2 < k-1), so the statistic
is alpha_p*0.1 + (1-alpha_p)*Hoyer — embarrassingly parallel.  With
blk_gap == 1 it is a true linear recurrence over centers, handled with an
associative scan.  Both reproduce the MATLAB output exactly.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp


def _centers(n_bins: int, p_len_k: int, dc_bin: int, gap: int) -> np.ndarray:
    """1-based block centers: half+dcbin : gap : n_bins-half (blk_sparse.m:20)."""
    half = p_len_k // 2
    return np.arange(half + dc_bin, n_bins - half + 1, gap)


def snr_column(xm: jnp.ndarray, dm: jnp.ndarray,
               nonzerofloor: float) -> jnp.ndarray:
    """The per-frame max-normalized local-SNR column the ring stores
    (blk_sparse.m's R_blk push)."""
    snr = xm / jnp.maximum(dm, nonzerofloor)
    return snr / jnp.max(snr)


def block_sparsity_stat(r_ring: jnp.ndarray, l: jnp.ndarray, *, n_bins: int,
                        p_len_k: int, p_len_l: int, dc_bin: int, gap: int,
                        alpha_p: float) -> jnp.ndarray:
    """Q statistic of the CURRENT ring contents (any column order — every
    window statistic is a sum over the ring's time axis).  Shared by the
    shift-ring path (exact engine, oracle-parity order) and the
    circular-ring path of the block-adaptive plan."""
    dtype = r_ring.dtype
    half = p_len_k // 2
    gap2 = (gap - 1) // 2
    n = p_len_k * p_len_l
    sqrt_n = float(np.sqrt(n))

    # Row stats, then direct window sums: 1-based center k covers 0-based
    # rows k-half..k+half-1.  Not prefix-sum differences: in f32 the
    # difference of two large cumsums cancels, goes negative on windows of
    # tiny values, and the sqrt below turns that into NaN.
    rs = jnp.sum(r_ring, axis=1)
    rq = jnp.sum(r_ring * r_ring, axis=1)

    ks = _centers(n_bins, p_len_k, dc_bin, gap)          # static
    rows = ks[:, None] - half + np.arange(p_len_k)[None, :]
    l1 = jnp.sum(rs[rows], axis=1)
    l2 = jnp.sqrt(jnp.sum(rq[rows], axis=1))
    p_tmp = (sqrt_n - l1 / l2) / (sqrt_n - 1.0)

    if gap >= 3:
        p_val = alpha_p * 0.1 + (1.0 - alpha_p) * p_tmp
    else:
        # true recurrence p_k = alpha*p_{k-1} + (1-alpha)*t_k, p_0-seed 0.1
        def combine(c1, c2):
            a1, b1 = c1
            a2, b2 = c2
            return a1 * a2, a2 * b1 + b2
        a = jnp.full_like(p_tmp, alpha_p)
        b = (1.0 - alpha_p) * p_tmp
        b = b.at[0].add(alpha_p * 0.1)
        a = a.at[0].set(0.0)
        _, p_val = jax.lax.associative_scan(combine, (a, b))

    # Scatter each center's value onto its +-gap2 neighborhood (0-based bins)
    j = np.arange(n_bins)
    ci = np.clip(np.round((j - (ks[0] - 1)) / gap).astype(int), 0, len(ks) - 1)
    center0 = ks[ci] - 1
    covered = np.abs(j - center0) <= gap2
    q = jnp.where(jnp.asarray(covered), p_val[jnp.asarray(ci)],
                  jnp.asarray(0.1, dtype))
    # low-bin backfill: Q(1:P_len_k-1) = Q(P_len_k + dc_bin)  (:32)
    q = q.at[: p_len_k - 1].set(q[p_len_k + dc_bin - 1])

    q_init = jnp.full((n_bins,), 0.1, dtype).at[:dc_bin].set(0.0)
    q = jnp.where(l > p_len_l, q, q_init)
    q = q.at[:dc_bin].set(0.0)
    return q


def block_sparsity_q(xm: jnp.ndarray, dm: jnp.ndarray, r_blk: jnp.ndarray,
                     l: jnp.ndarray, *, n_bins: int, p_len_k: int,
                     p_len_l: int, dc_bin: int, gap: int, alpha_p: float,
                     nonzerofloor: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One frame, shift-ring semantics (the exact engine / oracle-parity
    path).  xm, dm: (F,) reconstructions; r_blk: (F, P_len_l) ring;
    l: 1-based frame counter.  Returns (q (F,), r_blk_new)."""
    snr = snr_column(xm, dm, nonzerofloor)
    r_new = jnp.concatenate([r_blk[:, 1:], snr[:, None]], axis=1)
    q = block_sparsity_stat(r_new, l, n_bins=n_bins, p_len_k=p_len_k,
                            p_len_l=p_len_l, dc_bin=dc_bin, gap=gap,
                            alpha_p=alpha_p)
    return q, r_new


def make_block_sparsity_q_block(k_block: int, *, n_bins: int, p_len_k: int,
                                p_len_l: int, dc_bin: int, gap: int,
                                alpha_p: float):
    """Whole-block Q: all K frames' statistics in batched matmuls.

    Q has no sequential dependency — frame j's statistic reads only the
    last P_len_l frames' local-SNR columns, all computable from the
    block's batched reconstructions.  So instead of per-frame ring shifts
    and cumsums inside the frame scan (the dominant HBM/latency cost of
    the block plan at production shapes), both window sums become banded
    0/1-matrix GEMMs evaluated once per block:

      * time axis: ext = [ring | block columns] (F, P+K);
        rs/rq = ext @ W_t with W_t[c, j] = 1 iff frame j's P-deep window
        covers column c — one (F, P+K) x (P+K, K) matmul;
      * frequency axis: l1/l2 = rs.T @ W_f with W_f[f, c] = 1 iff bin f
        lies in center c's P_len_k window — one (K, F) x (F, C) matmul.

    Requires gap >= 3 (the reference default), where the smoothing seed is
    the constant 0.1 (module docstring); gap < 3 callers must use the
    sequential ``block_sparsity_q``.  Sum ORDER differs from the sequential
    window sums by f32 reduction LSBs — quality is re-gated against the
    golden fixtures, not assumed.

    Returns ``q_block(snr_cols (K,F), r_ring (F,P), ls (K,), n_valid)
    -> (q (K,F), r_ring_new (F,P))`` where n_valid counts the block's
    non-padding frames (the ring advances past exactly those columns).
    """
    if gap < 3:
        raise ValueError("block Q path requires gap >= 3 (sequential "
                         "recurrence otherwise; use block_sparsity_q)")
    half = p_len_k // 2
    gap2 = (gap - 1) // 2
    sqrt_n = float(np.sqrt(p_len_k * p_len_l))
    ks = _centers(n_bins, p_len_k, dc_bin, gap)

    # time-window band: frame j (0-based) covers ext columns j+1..j+P
    # (its own column P+j plus the P-1 before it)
    c_idx = np.arange(p_len_l + k_block)[:, None]
    j_idx = np.arange(k_block)[None, :]
    w_time = ((c_idx >= j_idx + 1) & (c_idx <= j_idx + p_len_l))
    # frequency band: center k (1-based) covers 0-based bins k-half..k+half-1
    f_idx = np.arange(n_bins)[:, None]
    w_freq = ((f_idx >= ks[None, :] - half) & (f_idx <= ks[None, :] + half - 1))
    # static scatter map from centers back to bins (module docstring quirk)
    j = np.arange(n_bins)
    ci = np.clip(np.round((j - (ks[0] - 1)) / gap).astype(int), 0, len(ks) - 1)
    covered = np.abs(j - ks[ci] + 1) <= gap2

    def q_block(snr_cols: jnp.ndarray, r_ring: jnp.ndarray,
                ls: jnp.ndarray, n_valid: jnp.ndarray):
        dtype = snr_cols.dtype
        ext = jnp.concatenate([r_ring, snr_cols.T], axis=1)    # (F, P+K)
        wt = jnp.asarray(w_time, dtype)
        wf = jnp.asarray(w_freq, dtype)
        rs = ext @ wt                                          # (F, K)
        rq = (ext * ext) @ wt
        l1 = rs.T @ wf                                         # (K, C)
        l2 = jnp.sqrt(rq.T @ wf)
        p_tmp = (sqrt_n - l1 / l2) / (sqrt_n - 1.0)
        p_val = alpha_p * 0.1 + (1.0 - alpha_p) * p_tmp
        q = jnp.where(jnp.asarray(covered)[None, :],
                      p_val[:, jnp.asarray(ci)], jnp.asarray(0.1, dtype))
        q = q.at[:, : p_len_k - 1].set(q[:, p_len_k + dc_bin - 1][:, None])
        q_init = jnp.full((n_bins,), 0.1, dtype).at[:dc_bin].set(0.0)
        q = jnp.where((ls > p_len_l)[:, None], q, q_init[None, :])
        q = q.at[:, :dc_bin].set(0.0)
        # ring advances past the valid columns only (suffix padding writes
        # nothing): new ring = ext columns n_valid..n_valid+P-1
        ring_new = jax.lax.dynamic_slice_in_dim(ext, n_valid, p_len_l, 1)
        return q, ring_new

    return q_block
