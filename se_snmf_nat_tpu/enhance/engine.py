"""The per-frame enhancement engine as a pure scan step.

Re-design of src/bnmf_sep_event_RT_IS16.m.  One step consumes a power
spectrum column and the 1-based frame counter, carries EngineState, and
emits the enhanced spectrum.  Differences from the reference are purely
representational, never semantic:

  * the dictionary H-solve and the online W-refit run as jit-able
    ``lax.while_loop`` MU solvers (nmf/solver.py) instead of re-entrant
    MATLAB calls;
  * the reference's dynamic column compaction + [remaining, refit, tail]
    reordering (engine :292-339) becomes a masked fixed-shape solve followed
    by a stable-argsort permutation — bitwise the same merged dictionary;
  * per-frame solver reseeding (rand('seed',1); rand(r,1)) becomes a
    precomputed constant init vector from the same legacy V4 stream;
  * frames are batched outside this step (STFT/iSTFT live in dsp/), and
    utterances batch with ``jax.vmap`` over (step, state).

The step is the SAME code for offline and streaming use — the reference's
key design point (one frame engine serving batch and mic paths,
SE_GUI.m:401 vs filewise_run_IS16.m:142) is kept.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig
from se_snmf_nat_tpu.dsp.mel import mel_matrix
from se_snmf_nat_tpu.enhance.blk_sparse import block_sparsity_q
from se_snmf_nat_tpu.enhance.state import EngineState, init_engine_state
from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_solve
from se_snmf_nat_tpu.utils.matlab_compat import matlab_v4_rand_matrix


class Engine(NamedTuple):
    step: Callable          # (EngineState, (ym, l)) -> (EngineState, outputs)
    init_state: Callable    # (dtype) -> EngineState
    cfg: PipelineConfig


def make_engine(cfg: PipelineConfig, b1_x: np.ndarray, b1_d: np.ndarray,
                b2_x: np.ndarray, b2_d: np.ndarray,
                dtype=jnp.float32, emit_sources: bool = False,
                warm_start: bool = False) -> Engine:
    """Build the scan step closed over the immutable dictionary parts.

    b1_*: separation-domain bases (mel or DFT per cfg.sep.b_sep_mode);
    b2_*: DFT reconstruction bases (filewise_run_IS16.m:46-51).

    emit_sources: also output the per-event / per-noise reconstruction
    spectra (engine :158-200 block layout from cfg.sep.event_rank /
    noise_rank; their per-class sums equal the xm_hat/dm_hat the gain
    uses, so separation adds outputs without changing the enhancement).

    warm_start: DOCUMENTED SEMANTIC DEVIATION, kept as a negative result —
    initialize each frame's H-solve from the previous frame's activations
    instead of the reference's per-frame ``rand('seed',1)`` re-init
    (sparse_nmf.m:112-134).  It lowered golden-wav corr to 0.87 (vs 0.997
    cold) and did not run faster on the previous accelerator.  Why: the
    production solver stops far from convergence (rel-err ~0.44 vs the
    eps=1e-6 solution at the reference's conv_eps=1e-3), so outputs are
    defined by the optimization TRAJECTORY from the specific init, not by
    the optimum — a warm trajectory lands somewhere else, and iterations
    only drop 27 -> 19 on average.  Frame 1 is identical by construction
    (a_warm seeds from the same legacy-V4 rand column).  The dictionary
    changes on 65% of M03 frames, which bounds segment speculation.
    """
    s, sep, ad, en, blk = cfg.signal, cfg.sep, cfg.adapt, cfg.enhance, cfg.blk
    if sep.blk_len_sep != 1 or sep.splice != 0:
        raise NotImplementedError(
            "reference block/splice engine branches are unreachable dead "
            "code (bnmf_sep_event_RT_IS16.m:85-100); only m=1/splice=0 "
            "streaming is defined")
    mel_mode = sep.b_sep_mode == "Mel"
    r_x, r_d, r_a = sep.r_x, sep.r_d, ad.r_a
    r = r_x + r_d
    n_bins = s.n_bins
    flr = s.nonzerofloor

    bx_sep = jnp.asarray(b1_x, dtype)
    bd_sep_tail = jnp.asarray(b1_d[:, r_a:], dtype)
    bx_dft = jnp.asarray(b2_x, dtype)
    bd_dft = jnp.asarray(b2_d, dtype)
    h0 = jnp.asarray(matlab_v4_rand_matrix(r, 1, cfg.nmf.random_seed), dtype)

    melmat = None
    if mel_mode:
        melmat = jnp.asarray(
            mel_matrix(s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T, dtype)

    solve_params = SnmfParams(
        beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps, flr=1e-9,
        precision=cfg.runtime.matmul_precision)

    # separation-solve W mask (engine :125-139); W updates are discarded
    semisup = sep.basis_update_n or sep.basis_update_e
    w_mask_np = np.zeros(r, bool)
    if sep.basis_update_n:
        w_mask_np[r_x:] = True
    if sep.basis_update_e:
        w_mask_np[:r_x] = True
    w_mask_sep = jnp.asarray(w_mask_np)
    h_mask_all = jnp.ones(r, bool)

    blk_kwargs = dict(n_bins=n_bins, p_len_k=blk.p_len_k, p_len_l=blk.p_len_l,
                      dc_bin=s.dc_bin, gap=blk.blk_gap, alpha_p=blk.alpha_p,
                      nonzerofloor=flr)

    # per-class dictionary blocks (1-based starts, last block runs to the
    # class end — engine :156-182)
    def _blocks(starts, total):
        starts0 = [int(v) - 1 for v in starts]
        return list(zip(starts0, starts0[1:] + [total]))

    event_blocks = _blocks(sep.event_rank, r_x)
    noise_blocks = _blocks(sep.noise_rank, r_d)

    def step(state: EngineState, xs):
        ym, l = xs                                # ym: (F,), l: 1-based int32
        ym = ym.astype(dtype)

        # ---- separation domain (engine :106-122)
        if mel_mode:
            ym_mel = melmat @ ym
            vn = jnp.sqrt(jnp.sum(ym_mel * ym_mel))
            tn = jnp.sqrt(jnp.sum(ym * ym))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = ym
        b_sep_d = jnp.concatenate([state.b_d_head, bd_sep_tail], axis=1)
        w_sep = jnp.concatenate([bx_sep, b_sep_d], axis=1)

        # ---- activation solve (engine :140-154)
        if warm_start:
            # floor unsticks any underflowed-to-zero activations (MU can
            # never leave an exact zero)
            h0_use = jnp.maximum(state.a_warm, jnp.asarray(1e-8, dtype))
            h0_use = h0_use[:, None]
        else:
            h0_use = h0
        res = snmf_solve(y_sep[:, None], w_sep, h0_use, w_mask_sep,
                         h_mask_all, solve_params, update_w=semisup,
                         update_h=True, need_stats=False)
        a = res.h[:, 0]

        # ---- reconstructions (engine :158-211)
        if mel_mode and sep.mel_conv:
            if emit_sources:
                x_srcs = [melmat.T @ (bx_sep[:, lo:hi] @ a[lo:hi])
                          for lo, hi in event_blocks]
                d_srcs = [melmat.T @ (b_sep_d[:, lo:hi]
                                      @ a[r_x + lo: r_x + hi])
                          for lo, hi in noise_blocks]
                xm_hat = sum(x_srcs)
                dm_hat = sum(d_srcs)
            else:
                xm_hat = melmat.T @ (bx_sep @ a[:r_x])
                dm_hat = melmat.T @ (b_sep_d @ a[r_x:])
            ym_dft = melmat.T @ y_sep
        else:
            # DFT mode: the adapted head doubles as the reconstruction
            # columns (B2 == B1 when B_sep_mode='DFT').  Coupled-dictionary
            # mel mode (MelConv=0) reconstructs with the fixed DFT basis.
            if mel_mode:
                b_dft_full = jnp.concatenate([bx_dft, bd_dft], axis=1)
            else:
                b_dft_full = jnp.concatenate(
                    [bx_dft, state.b_d_head, bd_dft[:, r_a:]], axis=1)
            if emit_sources:
                # block sums reproduce the reference's per-event loop
                # accumulation order (engine :156-200)
                x_srcs = [b_dft_full[:, lo:hi] @ a[lo:hi]
                          for lo, hi in event_blocks]
                d_srcs = [b_dft_full[:, r_x + lo: r_x + hi]
                          @ a[r_x + lo: r_x + hi]
                          for lo, hi in noise_blocks]
                xm_hat = sum(x_srcs)
                dm_hat = sum(d_srcs)
            else:
                xm_hat = b_dft_full[:, :r_x] @ a[:r_x]
                dm_hat = b_dft_full[:, r_x:] @ a[r_x:]
            ym_dft = ym

        # ---- block sparsity (engine :213-218)
        if blk.enabled:
            q, r_blk = block_sparsity_q(xm_hat, dm_hat, state.r_blk, l,
                                        **blk_kwargs)
        else:
            q, r_blk = jnp.ones_like(ym), state.r_blk

        # ---- adaptive noise floor + gain (engine :221-260)
        lambda_dav = jnp.where(l == 1, ym_dft, state.lambda_dav)
        a_d_mag = jnp.sum(a[r_x:]) / r_d
        a_x_mag = jnp.sum(a[:r_x]) / r_x
        beta = 20.0 * jnp.log10(a_d_mag / a_x_mag) * en.beta
        beta = jnp.clip(beta, en.beta, en.beta_max)
        lambda_dav = en.alpha_d * lambda_dav + (1 - en.alpha_d) * dm_hat * beta

        if en.method == "Wiener":
            gain = xm_hat / (xm_hat + dm_hat)
        else:
            eta = (en.alpha_eta * state.xm_tilde
                   + (1 - en.alpha_eta) * xm_hat * q) \
                / jnp.maximum(lambda_dav, flr)
            eta = jnp.maximum(en.eta_floor, eta)
            gain = eta / (eta + 1.0)
        gain = jnp.minimum(gain, 1.0)

        in_init = l <= ad.init_n_len
        gain = jnp.where(in_init, jnp.full_like(gain, flr), gain)
        a_x_mag = jnp.where(in_init, jnp.asarray(flr, dtype), a_x_mag)
        xm_tilde = gain * ym

        # ---- online noise-dictionary adaptation (engine :262-347)
        # adapt_train_n=False keeps the statically pruned program; with
        # adaptation compiled in, state.adapt_on is the SE_GUI push-to-talk
        # runtime switch (SE_GUI.m:393-435) — False makes frames supervised:
        # no trigger, so rings/update_switch/dictionary stay untouched
        q_control = (1.0 - jnp.mean(q)) * ad.ar_up
        gate = state.adapt_on if ad.adapt_train_n else False
        trigger = jnp.logical_and(gate, q_control * a_d_mag > a_x_mag)

        def adapted(op):
            state, = op
            # D_ref builds from the raw DFT power spectrum (engine :268-272)
            m_ref = (1.0 - gain).at[: s.dc_bin].set(flr)
            d_ref = jnp.where(in_init, ym, ym * m_ref)
            lam_blk = jnp.concatenate(
                [state.lambda_d_blk[:, 1:], d_ref[:, None]], axis=1)
            ad_blk = jnp.concatenate(
                [state.ad_blk[:, 1:], a[r_x: r_x + r_a, None]], axis=1)
            r_up = q_control * jnp.mean(ad_blk, axis=1) > a_x_mag
            do_solve = state.update_switch == ad.update_period

            def refit(op):
                head, lam_blk, ad_blk, r_up = op
                target = lam_blk if not mel_mode else melmat @ lam_blk
                w0 = head * r_up[None, :]
                h0a = ad_blk * r_up[:, None]
                # active short-circuits the MU loop on untriggered vmap
                # lanes (cond batches to select; see snmf_solve docstring)
                res = snmf_solve(target, w0, h0a, r_up,
                                 jnp.zeros(r_a, bool), solve_params,
                                 update_w=True, update_h=False,
                                 active=jnp.logical_and(trigger, do_solve),
                                 need_stats=False)
                merged = jnp.where(r_up[None, :], res.w, head)
                perm = jnp.argsort(r_up.astype(jnp.int32), stable=True)
                return merged[:, perm]

            head_new = jax.lax.cond(
                do_solve, refit, lambda op: op[0],
                (state.b_d_head, lam_blk, ad_blk, r_up))
            switch = jnp.where(do_solve, 1, state.update_switch + 1)
            return state._replace(
                b_d_head=head_new, lambda_d_blk=lam_blk, ad_blk=ad_blk,
                update_switch=switch.astype(jnp.int32))

        state_ad = jax.lax.cond(trigger, adapted, lambda op: op[0], (state,))

        new_state = state_ad._replace(
            lambda_dav=lambda_dav, xm_tilde=xm_tilde, r_blk=r_blk)
        if warm_start:
            new_state = new_state._replace(a_warm=a)
        if emit_sources:
            return new_state, (xm_tilde, jnp.stack(x_srcs), jnp.stack(d_srcs))
        return new_state, xm_tilde

    def init_state_fn(dtype_=dtype, matlab_ad_blk_init: bool = True):
        return init_engine_state(cfg, np.asarray(b1_d), n_bins, dtype_,
                                 matlab_ad_blk_init)

    return Engine(step=step, init_state=init_state_fn, cfg=cfg)
