"""Block-adaptive execution plan: batched solves + per-block dictionary
refits.

The exact adaptive scan refits the noise dictionary up to once per frame
(engine :293-346), which serializes every frame's H-solve behind the
previous frame's refit.  This plan trades refit granularity for matrix-unit
utilization: within a block of K frames the dictionary is frozen, so the
K activation solves batch into one (R,F)@(F,K) GEMM solve; ring pushes,
triggers and the gain chain run in a cheap inner scan; at the block
boundary one refit runs if any frame in the block triggered (using the
ring statistics exactly as the engine does).

This is a DOCUMENTED SEMANTIC DEVIATION from the reference's per-frame
online learning — the dictionary lags by up to K frames (K*10 ms of
audio).  Everything else follows the engine: the l==1 lambda_dav seed is
mode-correct (mel_conv seeds from the mel-projected spectrum,
engine.py:144,177) and the update_switch refit cycle honors
adapt.update_period (only every Nth trigger schedules a refit,
engine.py:214,234).  Quality is measured, not assumed: tests compare
against the exact scan plan (waveform correlation) and against the
reference golden output.  The exact plan remains the default; select with
``SnmfEnhancer(..., block_adapt=K)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig
from se_snmf_nat_tpu.dsp.stft import analysis_frames, overlap_add, synthesis_frames
from se_snmf_nat_tpu.enhance.state import EngineState
from se_snmf_nat_tpu.nmf.solver import (
    SnmfParams, snmf_h_solve_columns, snmf_h_solve_columns_split, snmf_solve)
from se_snmf_nat_tpu.utils.matlab_compat import matlab_v4_rand_matrix


def ring_ptr0() -> jnp.ndarray:
    """Initial circular-ring write pointer for the block step's carry."""
    return jnp.asarray(0, jnp.int32)


def rings_to_shift_layout(state: EngineState, ptr: jnp.ndarray,
                          rblk_shift: jnp.ndarray | None = None
                          ) -> EngineState:
    """Rotate the circularly-written rings back to the exact engine's
    shift layout (oldest column first).

    Inside the block plan the (F, m_a) noise-reference ring and the
    (R_a, m_a) activation ring are written with a circular pointer — an
    O(F) dynamic-update-slice per push instead of the O(F*m_a) whole-ring
    shift the exact engine mirrors from the reference
    (bnmf_sep_event_RT_IS16.m:263-292).  ``roll(ring, -ptr, axis=1)``
    reproduces the shift-ring contents BIT-EXACTLY (each push lands in the
    same chronological slot), so converting at a plan boundary hands the
    exact engine / checkpoints / state-carry consumers the identical state
    the shift implementation would have produced.

    The local-SNR ring (``r_blk``) needs no conversion: the block plan
    updates it once per block in shift layout (blk_sparse.py's
    ``make_block_sparsity_q_block``)."""
    del rblk_shift                     # kept for call-site compatibility
    return state._replace(
        lambda_d_blk=jnp.roll(state.lambda_d_blk, -ptr, axis=1),
        ad_blk=jnp.roll(state.ad_blk, -ptr, axis=1))


def make_block_step(cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d,
                    dtype=jnp.float32, k_block: int = 16,
                    iter_cap: int = 0, refit_iter_cap: int = 0,
                    fixed_iter: bool = False, split_solve: bool = False,
                    refit_fixed: bool = False,
                    _knockout: str | None = None):
    """The K-frame block step ((state, ring_ptr), (mag_blk, ls, ok)) ->
    ((state, ring_ptr), xm_tilde_seq) shared by the offline plan and the
    streaming session.

    ``_knockout`` is an INSTRUMENTATION hook for a time-budget harness,
    not a product knob: 'refit' skips
    the per-block refit cond entirely, 'q' forces the Q=1 path (which
    constant-folds the triggers off, eliminating the ring/refit machinery
    downstream — it measures the whole trigger complex, not the Q stat),
    'gain' trivializes the per-frame gain chain (keeping data deps),
    'solve1' caps the H-solve at one trip, 'rings' skips the ring
    push/roll (refit consumes the stale carried ring — isolates the ring
    HBM + selection-GEMM cost with triggers/refit still live), 'noscan'
    replaces the per-frame gain scan with batched stand-ins (no lax.scan
    at all — isolates the 88-step scan STRUCTURE cost, which the 'gain'
    knockout cannot see because it keeps the step count).  Each keeps shapes/dependences so
    stage cost = full - knockout (the r4/r5 knockout methodology).

    The carry's ``ring_ptr`` (see ``ring_ptr0``) is the circular write
    position of the two m_a-deep adaptation rings: pushes are O(F)
    dynamic-update-slice column writes instead of whole-ring shifts, and
    the per-block refit rolls the rings back to chronological order before
    consuming them — bit-identical results to the shift implementation at
    ~1/m_a of the ring HBM traffic (the dominant cost of the frame scan at
    production shapes: two (513+50, 100) rings re-materialized per frame
    is ~21 GB per 64x750-frame batch)."""
    s, sep, ad, en, blk = cfg.signal, cfg.sep, cfg.adapt, cfg.enhance, cfg.blk
    if sep.basis_update_n or sep.basis_update_e:
        raise ValueError("block-adaptive plan: supervised configs only")
    mel_mode = sep.b_sep_mode == "Mel"
    r_x, r_d, r_a = sep.r_x, sep.r_d, ad.r_a
    r = r_x + r_d
    flr = s.nonzerofloor

    bx = jnp.asarray(b1_x, dtype)
    bd_tail = jnp.asarray(b1_d[:, r_a:], dtype)
    bx_dft = jnp.asarray(b2_x, dtype)
    bd_dft = jnp.asarray(b2_d, dtype)
    melmat = None
    if mel_mode:
        from se_snmf_nat_tpu.dsp.mel import mel_matrix
        melmat = jnp.asarray(
            mel_matrix(s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T, dtype)
    h0_col = jnp.asarray(matlab_v4_rand_matrix(r, 1, cfg.nmf.random_seed),
                         dtype)
    # split_solve: the H-solve's basis splits into the lane-invariant part
    # (speech basis + non-adapted noise tail) and the per-lane adapted head
    # (state.b_d_head) so vmap emits one big shared GEMM over B*K columns
    # instead of B narrow per-lane GEMMs of K columns — see
    # snmf_h_solve_columns_split.  Rows of h reorder to [shared; head] for
    # the solve and reassemble to the engine's [x; head; tail] order after.
    if split_solve and r_a <= 0:
        raise ValueError("split_solve requires an adapted head (r_a > 0)")
    if split_solve:
        w_shared = jnp.concatenate([bx, bd_tail], axis=1)   # (F, r - r_a)
        h0_sh = jnp.concatenate([h0_col[:r_x], h0_col[r_x + r_a:]], axis=0)
        h0_hd = h0_col[r_x: r_x + r_a]
    # iter_cap (opt-in, measured): truncates BOTH the H-solve and the
    # refit W-solve MU loops.  The per-column convergence distribution at
    # the production KL config freezes the median column by iteration 25
    # and p95 by 31; only ~1% of columns (oscillating relative-cost tests)
    # run to the reference's max_iter=100, and every other column pays for
    # them because the batched while_loop runs to the slowest column.
    # Golden-wav quality at cap 32/40/64 is UNCHANGED vs cap 100 (corr
    # .9930/.9946-.9949 on M03/LM at K=48 — the r2 cap sweep); cap 40 is
    # the measured speed optimum (+6% headline).
    eff_max_iter = (min(cfg.nmf.max_iter, iter_cap) if iter_cap
                    else cfg.nmf.max_iter)
    if _knockout == "solve1":
        eff_max_iter = 1
    params = SnmfParams(
        beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
        max_iter=eff_max_iter, conv_eps=cfg.nmf.conv_eps, flr=1e-9,
        precision=cfg.runtime.matmul_precision)
    # refit_iter_cap: separate (tighter) cap for the per-block dictionary
    # refit W-solve.  Speed-neutral on the previous accelerator (the refit
    # while_loops already exit early on their per-column relative-cost
    # tests, unlike the straggler-bound H-solves) and quality-invariant
    # down to cap 16 (golden corr .9925/.9940 identical to uncapped;
    # cap 12 dents LM to .9937).  Kept as a validated option for shapes
    # where refit convergence is slower.
    import dataclasses as _dc
    params_refit = (_dc.replace(params,
                                max_iter=min(eff_max_iter, refit_iter_cap))
                    if refit_iter_cap else params)
    # refit_fixed (opt-in, requires refit_iter_cap): FIXED-iteration refit
    # W-solves, the same trade the H-solves' fixed_iter makes.  Why it pays
    # HERE despite refits converging early: the early stop's per-trip KL
    # cost pass is a (F, m_a) log pass per trip per lane, and the whole
    # refit branch (entry, per-trip cost passes, exit) is not free even
    # when the MU trips are.  Trajectories
    # change (solves run to the cap), so golden quality re-gates the
    # option (bench --pareto rows).
    if refit_fixed:
        if not refit_iter_cap:
            raise ValueError("refit_fixed requires refit_iter_cap")
        params_refit = _dc.replace(params_refit, conv_eps=0.0)
    # fixed_iter (opt-in, requires a cap): drop the per-column early stop
    # from the H-SOLVES (conv_eps=0) so the solver also skips the per-trip
    # KL cost — a full elementwise pass over (F, K) incl. a log
    # (nmf/solver.py cost-skip).  The GEMM count per trip is unchanged
    # (frozen columns were masked, not cheaper); trajectories differ
    # (columns that froze early now update to the cap), so the quality
    # gates decide.  Refits KEEP the early stop:
    # their while_loops genuinely exit early (see refit_iter_cap note),
    # so fixed-iteration would make them slower, not faster.
    if fixed_iter and eff_max_iter < cfg.nmf.max_iter:
        params = _dc.replace(params, conv_eps=0.0)
    m_a = ad.m_a
    # gap >= 3 (the reference default): Q leaves the scan as banded GEMMs;
    # gap < 3 makes Q a true recurrence over centers, so it stays
    # per-frame in the scan (enhance/blk_sparse.py module docstring)
    q_sequential = blk.enabled and blk.blk_gap < 3
    q_block_fn = None
    if blk.enabled and not q_sequential:
        from se_snmf_nat_tpu.enhance.blk_sparse import (
            make_block_sparsity_q_block)
        q_block_fn = make_block_sparsity_q_block(
            k_block, n_bins=s.n_bins, p_len_k=blk.p_len_k,
            p_len_l=blk.p_len_l, dc_bin=s.dc_bin, gap=blk.blk_gap,
            alpha_p=blk.alpha_p)
    blk_kwargs = dict(n_bins=s.n_bins, p_len_k=blk.p_len_k,
                      p_len_l=blk.p_len_l, dc_bin=s.dc_bin, gap=blk.blk_gap,
                      alpha_p=blk.alpha_p, nonzerofloor=flr)

    def block_step(carry, xs):
        state, ring_ptr = carry
        mag_blk, ls, ok_blk = xs                 # (K, F), (K,), (K,) bool
        w_sep = jnp.concatenate([bx, state.b_d_head, bd_tail], axis=1)
        if mel_mode:
            ym_mel = mag_blk @ melmat.T
            vn = jnp.sqrt(jnp.sum(ym_mel * ym_mel, axis=1, keepdims=True))
            tn = jnp.sqrt(jnp.sum(mag_blk * mag_blk, axis=1, keepdims=True))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = mag_blk
        if split_solve:
            hs, hh = snmf_h_solve_columns_split(
                y_sep.T, w_shared, state.b_d_head,
                jnp.broadcast_to(h0_sh, (r - r_a, k_block)),
                jnp.broadcast_to(h0_hd, (r_a, k_block)), params)
            a = jnp.concatenate([hs[:r_x], hh, hs[r_x:]], axis=0)
        else:
            res = snmf_h_solve_columns(
                y_sep.T, w_sep, jnp.broadcast_to(h0_col, (r, k_block)),
                params)
            a = res.h                            # (r, K)
        if mel_mode and sep.mel_conv:
            xm = ((w_sep[:, :r_x] @ a[:r_x]).T @ melmat)      # (K, F_dft)
            dm = ((w_sep[:, r_x:] @ a[r_x:]).T @ melmat)
        elif mel_mode:
            xm = (bx_dft @ a[:r_x]).T
            dm = (bd_dft @ a[r_x:]).T
        else:
            xm = (w_sep[:, :r_x] @ a[:r_x]).T    # (K, F)
            dm = (w_sep[:, r_x:] @ a[r_x:]).T
        a_d_mag = jnp.sum(a[r_x:], axis=0) / r_d
        a_x_mag = jnp.sum(a[:r_x], axis=0) / r_x
        # l==1 lambda_dav seed matches the engine per mode: mel_conv seeds
        # from the mel-projected-back spectrum ym_dft = melmat.T @ y_sep
        # (engine.py:144,177); every other mode seeds from the raw DFT mag
        if mel_mode and sep.mel_conv:
            ym_dft_blk = y_sep @ melmat
        else:
            ym_dft_blk = mag_blk

        # whole-block Q: no frame in the block depends on another frame's
        # Q (gap >= 3), so the windowed statistics leave the sequential
        # scan and run as banded-matrix GEMMs once per block
        # (blk_sparse.py); the local-SNR ring updates once per block in
        # shift layout.  gap < 3 computes Q per frame inside the scan.
        if blk.enabled and not q_sequential and _knockout != "q":
            snr_blk = xm / jnp.maximum(dm, flr)              # (K, F)
            snr_blk = snr_blk / jnp.max(snr_blk, axis=1, keepdims=True)
            n_valid_blk = jnp.sum(ok_blk, dtype=jnp.int32)
            q_blk, r_blk_batched = q_block_fn(snr_blk, state.r_blk, ls,
                                              n_valid_blk)
        else:
            q_blk = jnp.ones_like(mag_blk)
            r_blk_batched = state.r_blk
        qc_blk = (1.0 - jnp.mean(q_blk, axis=1)) * ad.ar_up  # (K,)

        def frame_step(carry, fxs):
            if q_sequential:
                (lambda_dav_c, xm_tilde_prev, r_blk_prev,
                 switch, any_refit, qctl_last, ax_last) = carry
            else:
                (lambda_dav_c, xm_tilde_prev,
                 switch, any_refit, qctl_last, ax_last) = carry
                r_blk_prev = r_blk_c = None
            (ym, ym_dft, xm_hat, dm_hat, a_col, ad_mag, ax_mag, l, ok,
             q, q_control) = fxs
            if q_sequential:
                from se_snmf_nat_tpu.enhance.blk_sparse import (
                    block_sparsity_q)
                q, r_blk_c = block_sparsity_q(xm_hat, dm_hat, r_blk_prev,
                                              l, **blk_kwargs)
                q_control = (1.0 - jnp.mean(q)) * ad.ar_up
            lambda_dav = jnp.where(l == 1, ym_dft, lambda_dav_c)
            if _knockout == "gain":
                # trivialized chain: keeps every input/carry dependence
                # at ~zero VPU work
                lambda_dav = lambda_dav + dm_hat * jnp.asarray(1e-9, dtype)
                gain = jnp.minimum(
                    xm_tilde_prev * jnp.asarray(1e-9, dtype)
                    + q * jnp.asarray(1e-9, dtype) + 0.5, 1.0)
            else:
                beta = jnp.clip(
                    20.0 * jnp.log10(ad_mag / ax_mag) * en.beta,
                    en.beta, en.beta_max)
                lambda_dav = en.alpha_d * lambda_dav \
                    + (1 - en.alpha_d) * dm_hat * beta
                if en.method == "Wiener":
                    gain = xm_hat / (xm_hat + dm_hat)
                else:
                    eta = (en.alpha_eta * xm_tilde_prev
                           + (1 - en.alpha_eta) * xm_hat * q) \
                        / jnp.maximum(lambda_dav, flr)
                    eta = jnp.maximum(en.eta_floor, eta)
                    gain = eta / (eta + 1.0)
                gain = jnp.minimum(gain, 1.0)
            in_init = l <= ad.init_n_len
            gain = jnp.where(in_init, jnp.full_like(gain, flr), gain)
            ax_mag = jnp.where(in_init, jnp.asarray(flr, dtype), ax_mag)
            xm_tilde = gain * ym

            # trigger (engine :263-292); the ring pushes themselves happen
            # in ONE bulk write per block below — the scan only emits each
            # frame's push candidate and flag.  state.adapt_on is the
            # runtime SE_GUI-style adaptation switch (see EngineState)
            gate = state.adapt_on if ad.adapt_train_n else False
            trig = jnp.logical_and(gate, q_control * ad_mag > ax_mag)
            trig = jnp.logical_and(trig, ok)
            m_ref = (1.0 - gain).at[: s.dc_bin].set(flr)
            d_ref = jnp.where(in_init, ym, ym * m_ref)
            # refit cycle: only every update_period-th trigger refits
            # (engine.py:214,234 — the reference's update_switch counter,
            # bnmf_sep_event_RT_IS16.m:293); the refit itself still waits
            # for the block boundary (the documented K-frame lag)
            do_solve = jnp.logical_and(trig,
                                       switch == ad.update_period)
            switch_new = jnp.where(trig,
                                   jnp.where(do_solve, 1, switch + 1), switch)
            # BOTH refit-gate statistics come from the refit-scheduling
            # (do_solve) frame, matching the engine's r_up computed at that
            # frame (engine.py:238) — ax_last previously tracked the last
            # VALID frame, mixing frames' statistics (review finding)
            qctl_last = jnp.where(do_solve, q_control, qctl_last)
            ax_last = jnp.where(do_solve, ax_mag, ax_last)
            out = jnp.where(ok, xm_tilde, jnp.zeros_like(xm_tilde))
            # bucket-padding frames must not touch the carried state
            new_carry = (jnp.where(ok, lambda_dav, lambda_dav_c),
                         jnp.where(ok, xm_tilde, xm_tilde_prev))
            if q_sequential:
                new_carry += (jnp.where(ok, r_blk_c, r_blk_prev),)
            new_carry += (jnp.where(ok, switch_new, switch),
                          any_refit | do_solve, qctl_last, ax_last)
            return new_carry, (out, d_ref, trig)

        if _knockout == "noscan":
            # no frame scan at all: batched stand-ins with the data deps
            # kept (outputs touch mag/xm/dm/q; trig touches qc/ok)
            tiny = jnp.asarray(1e-9, dtype)
            xm_tilde_seq = 0.5 * mag_blk + tiny * (xm + dm + q_blk)
            d_ref_seq = 0.5 * mag_blk
            trig_seq = jnp.logical_and(ok_blk, qc_blk > 0)
            lambda_dav = state.lambda_dav + tiny * jnp.sum(xm_tilde_seq)
            xm_tilde_last = xm_tilde_seq[-1]
            switch_out = state.update_switch
            any_trig = jnp.any(trig_seq)
            q_control = qc_blk[-1]
            a_x_last = a_x_mag[-1] if False else jnp.asarray(
                float(flr), dtype)
            r_blk_new = r_blk_batched if not q_sequential else state.r_blk
        else:
            carry0 = (state.lambda_dav, state.xm_tilde)
            if q_sequential:
                carry0 += (state.r_blk,)
            carry0 += (state.update_switch,
                       jnp.asarray(False), jnp.asarray(0.0, dtype),
                       jnp.asarray(float(flr), dtype))
            carry_out, (xm_tilde_seq, d_ref_seq, trig_seq) = jax.lax.scan(
                frame_step, carry0,
                (mag_blk, ym_dft_blk, xm, dm, a.T, a_d_mag, a_x_mag, ls,
                 ok_blk, q_blk, qc_blk))
            if q_sequential:
                (lambda_dav, xm_tilde_last, r_blk_new, switch_out,
                 any_trig, q_control, a_x_last) = carry_out
            else:
                (lambda_dav, xm_tilde_last, switch_out,
                 any_trig, q_control, a_x_last) = carry_out
                r_blk_new = r_blk_batched

        # bulk circular-ring push: the j-th triggered frame of the block
        # lands in slot (ptr + j) % m_a — the same chronological slot the
        # per-frame shift implementation fills (engine :263-292) — via one
        # masked scatter per ring per BLOCK (untriggered frames target the
        # out-of-bounds slot and drop), instead of per-frame ring shifts
        # whose HBM traffic dominated the frame scan
        rank = jnp.cumsum(trig_seq.astype(jnp.int32),
                          dtype=jnp.int32) - jnp.asarray(1, jnp.int32)
        n_trig = jnp.sum(trig_seq, dtype=jnp.int32)
        # with more than m_a triggers in one block (possible when
        # k_block > adapt.m_a, e.g. the snmf_techwin_rt preset's m_a=16),
        # slots would wrap and collide; only the NEWEST m_a pushes survive
        # a shift ring, so older ones drop too (keeps scatter targets
        # unique and the chronological roll below exact)
        keep = jnp.logical_and(trig_seq, rank >= n_trig - m_a)
        pos = jnp.where(keep, (ring_ptr + rank) % m_a,
                        jnp.asarray(m_a, jnp.int32))
        # ring push and chronological roll as ONE-HOT GEMMs at HIGHEST
        # precision instead of scatter / dynamic roll: column scatters and
        # dynamic gathers over the (F, m_a)/(r_a, m_a) rings were slow on
        # the previous accelerator.  A 0/1-selection matmul is VALUE-EXACT
        # at HIGHEST: each output column sums exactly one nonzero product
        # a*1, and HIGHEST keeps a's full f32 mantissa (on the H100 it is
        # an fp32 product; HIGH and DEFAULT are TF32 there and are NOT
        # exact).  Whether the scatter form is faster on the H100 is not
        # measured.
        slot = jnp.arange(m_a, dtype=jnp.int32)
        onehot = (pos[:, None] == slot[None, :]).astype(dtype)   # (K, m_a)
        written = jnp.any(pos[:, None] == slot[None, :], axis=0)
        hi = jax.lax.Precision.HIGHEST
        if _knockout == "rings":
            # skip the pushes at COMPILE time (a traced all-False where
            # would still execute the GEMMs): refit consumes the stale
            # carried ring, isolating the push machinery's cost
            lam_blk = state.lambda_d_blk
            ad_blk = state.ad_blk
        else:
            lam_blk = jnp.where(
                written[None, :],
                jnp.matmul(d_ref_seq.T, onehot, precision=hi),
                state.lambda_d_blk)
            ad_blk = jnp.where(
                written[None, :],
                jnp.matmul(a[r_x: r_x + r_a], onehot, precision=hi),
                state.ad_blk)
        ptr_out = ((ring_ptr + n_trig) % m_a).astype(jnp.int32)

        # one refit per block if any VALID frame triggered (engine :287-346
        # with the last valid triggered frame's gate statistics).  The rings
        # roll back to chronological (shift) order first so the refit's
        # GEMM reductions see the exact column order of the shift
        # implementation — results are bit-identical; the roll is the same
        # one-hot-GEMM trick (out[:, j] = ring[:, (j + ptr) % m_a]).
        perm = (slot[:, None] == ((slot[None, :] + ptr_out) % m_a)
                ).astype(dtype)                                  # (m_a, m_a)
        lam_s = jnp.matmul(lam_blk, perm, precision=hi)
        ad_s = jnp.matmul(ad_blk, perm, precision=hi)
        r_up = q_control * jnp.mean(ad_s, axis=1) > a_x_last

        def refit(op):
            head, lam_s, ad_s, r_up = op
            target = lam_s if not mel_mode else melmat @ lam_s
            w0 = head * r_up[None, :]
            h0a = ad_s * r_up[:, None]
            res = snmf_solve(target, w0, h0a, r_up, jnp.zeros(r_a, bool),
                             params_refit, update_w=True, update_h=False,
                             active=any_trig, need_stats=False)
            merged = jnp.where(r_up[None, :], res.w, head)
            perm = jnp.argsort(r_up.astype(jnp.int32), stable=True)
            return merged[:, perm]

        if _knockout == "refit":
            head_new = state.b_d_head
        else:
            head_new = jax.lax.cond(any_trig, refit, lambda op: op[0],
                                    (state.b_d_head, lam_s, ad_s, r_up))
        new_state = state._replace(
            b_d_head=head_new, lambda_dav=lambda_dav,
            xm_tilde=xm_tilde_last, r_blk=r_blk_new,
            lambda_d_blk=lam_blk, ad_blk=ad_blk,
            update_switch=switch_out.astype(jnp.int32))
        return (new_state, ptr_out), xm_tilde_seq

    return block_step


def make_block_adaptive_run(cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d,
                            dtype=jnp.float32, k_block: int = 16,
                            iter_cap: int = 0, dft_matmul: bool = False,
                            refit_iter_cap: int = 0,
                            fixed_iter: bool = False,
                            split_solve: bool = False,
                            refit_fixed: bool = False,
                            dft_precision: str | None = None,
                            idft_precision: str | None = None,
                            _knockout: str | None = None):
    """Returns jitted run(frames (T,L), state0: EngineState, win) ->
    (y, state).

    dft_precision / idft_precision override the matmul-transform precision
    per direction (None = dsp/stft module defaults).  The production plan
    (headline.py) runs analysis at 'high' and synthesis at 'default': analysis
    rounding is amplified through the NMF solver trajectory (-.0009 golden
    corr at 'default'), synthesis rounding adds only linear noise to an
    output whose golden residual is ~9% rel."""
    s = cfg.signal
    block_step = make_block_step(cfg, b1_x, b1_d, b2_x, b2_d, dtype, k_block,
                                 iter_cap, refit_iter_cap,
                                 fixed_iter=fixed_iter,
                                 split_solve=split_solve,
                                 refit_fixed=refit_fixed,
                                 _knockout=_knockout)

    @jax.jit
    def run(frames, state0, win_arr, t_valid):
        mag, phase = analysis_frames(
            frames, win_arr, s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
            s.preemph, dft_matmul=dft_matmul, precision=dft_precision)
        t = mag.shape[0]
        if t % k_block:   # static shape: trace-time contract check
            raise ValueError(
                f"block-adaptive run needs frame count divisible by "
                f"k_block={k_block}, got {t} (the pipeline's frame_bucket "
                f"alignment guarantees this; pad frames before calling)")
        n_blocks = t // k_block
        mag_b = mag[: n_blocks * k_block].reshape(n_blocks, k_block, -1)
        ls = jnp.arange(1, n_blocks * k_block + 1,
                        dtype=jnp.int32).reshape(n_blocks, k_block)
        ok = (ls <= t_valid)
        (state, ptr), xm_blocks = jax.lax.scan(
            block_step, (state0, ring_ptr0()), (mag_b, ls, ok))
        # returned state keeps the external shift-ring contract (bit-exact
        # — see rings_to_shift_layout) for carry/checkpoint/exact-plan use
        state = rings_to_shift_layout(state, ptr)
        xm_tilde = xm_blocks.reshape(n_blocks * k_block, -1)
        out_frames = synthesis_frames(
            xm_tilde, phase[: n_blocks * k_block], s.framelength,
            s.fftlength, win_arr, s.pow, s.dc_bin_back, s.overlapscale,
            s.preemph, dft_matmul=dft_matmul, precision=idft_precision)
        return overlap_add(out_frames, s.frameshift), state

    return run
