"""Fast execution plan for non-adaptive configurations.

When the noise dictionary is fixed (adapt_train_n=False — the SNMF
baseline, Exemplar, semi-supervised and Techwin-SNMF presets), every
frame's activation solve is INDEPENDENT: same dictionary, same V4-seeded
init, per-frame convergence (the reference re-seeds the solver each frame,
sparse_nmf.m:112-114).  The sequential scan is then only needed for the
cheap elementwise gain recurrences — so this plan:

  1. batched STFT for the whole utterance (and batch);
  2. ONE nmf.snmf_h_solve_columns call over ALL frames — the per-frame
     513x200 GEMVs become (200,513)@(513,T*B) GEMMs with per-column
     early stopping, numerically identical to the sequential solves;
  3. reconstructions as two big GEMMs;
  4. the block-sparsity statistic Q for ALL frames in one banded-GEMM
     batch (blk_sparse.make_block_sparsity_q_block — causal windows, so
     no frame reads another's result), leaving a light lax.scan that
     carries only the (lambda_dav, xm_tilde) MMSE-gain recurrences
     (engine :213-260 math);
  5. batched iSTFT + OLA.

Semi-supervised configs (basis_update_n/e) keep per-frame W co-updates that
are DISCARDED each frame (engine :140-154) — the H trajectory still depends
on them, so those configs stay on the scan plan; this plan covers the
supervised fixed-dictionary family.  Outputs are gated bit-exact (x64)
against the scan plan in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig
from se_snmf_nat_tpu.dsp.mel import mel_matrix
from se_snmf_nat_tpu.dsp.stft import analysis_frames, overlap_add, synthesis_frames
from se_snmf_nat_tpu.enhance.blk_sparse import (
    block_sparsity_q, make_block_sparsity_q_block)
from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_h_solve_columns
from se_snmf_nat_tpu.utils.matlab_compat import matlab_v4_rand_matrix


def supports_fast_plan(cfg: PipelineConfig) -> bool:
    return (not cfg.adapt.adapt_train_n
            and not cfg.sep.basis_update_n
            and not cfg.sep.basis_update_e
            and cfg.sep.splice == 0 and cfg.sep.blk_len_sep == 1)


def make_fast_run(cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d,
                  dtype=jnp.float32, dft_matmul: bool = False,
                  dft_precision: str | None = None,
                  idft_precision: str | None = None):
    """Returns jitted run(frames (T,L)) -> y samples — the whole-utterance
    non-adaptive plan."""
    if not supports_fast_plan(cfg):
        raise ValueError("config requires the scan plan")
    s, sep, ad, en, blk = cfg.signal, cfg.sep, cfg.adapt, cfg.enhance, cfg.blk
    mel_mode = sep.b_sep_mode == "Mel"
    r_x, r_d = sep.r_x, sep.r_d
    r = r_x + r_d
    flr = s.nonzerofloor

    bx_sep = jnp.asarray(b1_x, dtype)
    bd_sep = jnp.asarray(b1_d, dtype)
    w_sep = jnp.concatenate([bx_sep, bd_sep], axis=1)
    bx_dft = jnp.asarray(b2_x, dtype)
    bd_dft = jnp.asarray(b2_d, dtype)
    h0_col = jnp.asarray(matlab_v4_rand_matrix(r, 1, cfg.nmf.random_seed),
                         dtype)
    melmat = None
    if mel_mode:
        melmat = jnp.asarray(
            mel_matrix(s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T, dtype)

    # two-phase straggler compaction (SnmfParams.split_iter) is a validated
    # option (bit-exact, tests/test_nmf.py), default off: splitting the
    # solver's single while_loop into three adds round trips of the
    # (B, F, T) working set.  Not measured on the H100.
    params = SnmfParams(
        beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps, flr=1e-9,
        precision=cfg.runtime.matmul_precision)

    @jax.jit
    def run(frames, win_arr):
        mag, phase = analysis_frames(
            frames, win_arr, s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
            s.preemph, dft_matmul=dft_matmul,
            precision=dft_precision)                 # (T, F)
        t = mag.shape[0]
        if mel_mode:
            ym_mel = mag @ melmat.T                  # (T, F_mel)
            vn = jnp.sqrt(jnp.sum(ym_mel * ym_mel, axis=1, keepdims=True))
            tn = jnp.sqrt(jnp.sum(mag * mag, axis=1, keepdims=True))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = mag
        # ---- ONE batched activation solve over all frames
        res = snmf_h_solve_columns(
            y_sep.T, w_sep, jnp.broadcast_to(h0_col, (r, t)), params)
        a = res.h                                    # (r, T)
        # ---- reconstructions as big GEMMs
        if mel_mode and sep.mel_conv:
            xm = (melmat.T @ (bx_sep @ a[:r_x])).T
            dm = (melmat.T @ (bd_sep @ a[r_x:])).T
            ym_dft = (melmat.T @ y_sep.T).T
        else:
            if mel_mode:
                xm = (bx_dft @ a[:r_x]).T
                dm = (bd_dft @ a[r_x:]).T
            else:
                xm = (bx_sep @ a[:r_x]).T
                dm = (bd_sep @ a[r_x:]).T
            ym_dft = mag
        a_d_mag = jnp.sum(a[r_x:], axis=0) / r_d     # (T,)
        a_x_mag = jnp.sum(a[:r_x], axis=0) / r_x
        ls = jnp.arange(1, t + 1, dtype=jnp.int32)

        # Q for the WHOLE utterance in one banded-GEMM batch (no
        # adaptation here, so no frame feeds back into any other frame's
        # statistic — see enhance/blk_sparse.make_block_sparsity_q_block);
        # the gain scan then carries only the two (F,) recurrences.
        # gap < 3 makes Q a true recurrence over centers, so it stays
        # per-frame inside the scan (with the ring in the carry).
        q_sequential = blk.enabled and blk.blk_gap < 3
        if blk.enabled and not q_sequential:
            q_fn = make_block_sparsity_q_block(
                t, n_bins=s.n_bins, p_len_k=blk.p_len_k,
                p_len_l=blk.p_len_l, dc_bin=s.dc_bin, gap=blk.blk_gap,
                alpha_p=blk.alpha_p)
            snr_all = xm / jnp.maximum(dm, flr)
            snr_all = snr_all / jnp.max(snr_all, axis=1, keepdims=True)
            q_all, _ = q_fn(snr_all, jnp.zeros((s.n_bins, blk.p_len_l),
                                               dtype), ls,
                            jnp.asarray(t, jnp.int32))
        else:
            q_all = jnp.ones_like(mag)
        blk_kwargs = dict(n_bins=s.n_bins, p_len_k=blk.p_len_k,
                          p_len_l=blk.p_len_l, dc_bin=s.dc_bin,
                          gap=blk.blk_gap, alpha_p=blk.alpha_p,
                          nonzerofloor=flr)

        def step(carry, xs):
            if q_sequential:
                lambda_dav, xm_tilde_prev, r_blk_c = carry
            else:
                lambda_dav, xm_tilde_prev = carry
                r_blk_c = None
            ym, xm_hat, dm_hat, ymd, ad_mag, ax_mag, l, q = xs
            if q_sequential:
                q, r_blk_c = block_sparsity_q(xm_hat, dm_hat, r_blk_c, l,
                                              **blk_kwargs)
            lambda_dav = jnp.where(l == 1, ymd, lambda_dav)
            beta = 20.0 * jnp.log10(ad_mag / ax_mag) * en.beta
            beta = jnp.clip(beta, en.beta, en.beta_max)
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
            xm_tilde = gain * ym
            out_carry = ((lambda_dav, xm_tilde, r_blk_c) if q_sequential
                         else (lambda_dav, xm_tilde))
            return out_carry, xm_tilde

        state0 = (jnp.zeros((s.n_bins,), dtype),
                  jnp.zeros((s.n_bins,), dtype))
        if q_sequential:
            state0 = state0 + (jnp.zeros((s.n_bins, blk.p_len_l), dtype),)
        _, xm_tilde = jax.lax.scan(
            step, state0, (mag, xm, dm, ym_dft, a_d_mag, a_x_mag, ls, q_all))
        out_frames = synthesis_frames(
            xm_tilde, phase, s.framelength, s.fftlength, win_arr, s.pow,
            s.dc_bin_back, s.overlapscale, s.preemph,
            dft_matmul=dft_matmul, precision=idft_precision)
        return overlap_add(out_frames, s.frameshift)

    return run
