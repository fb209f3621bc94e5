"""Streaming engine state — the JAX equivalent of init_buff.m's ``g`` struct.

Everything is a fixed-shape pytree so it can be a ``lax.scan`` carry, be
donated across steps, and be checkpointed (orbax/npz).  The adapted part of
the noise dictionary is held separately from its immutable tail: the
reference only ever refits the leading R_a columns and re-appends the
original tail every rebuild (engine :316-339), so the carry is (F, R_a),
not (F, R_d).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig
from se_snmf_nat_tpu.utils.matlab_compat import MatlabTwister


class EngineState(NamedTuple):
    b_d_head: jnp.ndarray      # (F_sep, R_a) adapted leading noise columns
    lambda_dav: jnp.ndarray    # (F,) DD-smoothed noise PSD
    xm_tilde: jnp.ndarray      # (F,) previous enhanced spectrum (MMSE prior)
    r_blk: jnp.ndarray         # (F, P_len_l) local-SNR history ring
    lambda_d_blk: jnp.ndarray  # (F, m_a) DFT-domain noise-reference ring
    ad_blk: jnp.ndarray        # (R_a, m_a) noise-activation ring
    update_switch: jnp.ndarray  # int32 scalar
    a_warm: jnp.ndarray        # (R,) previous frame's activations; read
    #                            only by warm-start plans (engine.py), and
    #                            carried untouched by reference-exact plans
    # Runtime adaptation switch — SE_GUI.m:393-435's push-to-talk NAT
    # toggle.  A TRACED scalar carried in the state so flipping it
    # mid-stream (StreamingSession.set_adaptation) recompiles nothing;
    # while False, triggers cannot fire, so rings, update_switch and the
    # dictionary head stay untouched (the reference's supervised frames).
    # Only consulted by plans built with cfg.adapt.adapt_train_n=True —
    # config-off plans keep the statically pruned no-adaptation program.
    # Default is a plain Python bool, NOT jnp.asarray(True): a jnp default
    # evaluates at import time and would start the backend (and reserve
    # the card's memory) in any process that merely imports this module.
    # JAX traces a Python bool leaf to the same bool[] aval, so use sites
    # are unchanged.
    adapt_on: jnp.ndarray | bool = True


def init_engine_state(cfg: PipelineConfig, b_d_sep: np.ndarray,
                      n_bins: int, dtype=jnp.float32,
                      matlab_ad_blk_init: bool = True) -> EngineState:
    """init_buff.m equivalent.  b_d_sep: separation-domain noise basis; its
    leading R_a columns seed the adapted head.

    matlab_ad_blk_init: seed the activation ring from MATLAB's startup
    Twister stream (init_buff.m:37-38) for oracle parity; the values wash
    out of the ring after m_a adaptation pushes either way.
    """
    ad = cfg.adapt
    if matlab_ad_blk_init:
        tw = MatlabTwister(0)
        _ = tw.rand(b_d_sep.shape[1], cfg.sep.blk_len_sep)  # g.A_d (unused)
        ad_blk = tw.rand(ad.r_a, ad.m_a)
    else:
        ad_blk = np.full((ad.r_a, ad.m_a), 0.5)
    # warm-start seed = the same legacy-V4 rand column every frame's H-solve
    # would use cold (sparse_nmf.m:112-134), so frame 1 is identical either way
    from se_snmf_nat_tpu.utils.matlab_compat import matlab_v4_rand_matrix
    r = cfg.sep.r_x + cfg.sep.r_d
    a0 = matlab_v4_rand_matrix(r, 1, cfg.nmf.random_seed)[:, 0]
    return EngineState(
        b_d_head=jnp.asarray(b_d_sep[:, : ad.r_a], dtype),
        lambda_dav=jnp.zeros((n_bins,), dtype),
        xm_tilde=jnp.zeros((n_bins,), dtype),
        r_blk=jnp.zeros((n_bins, cfg.blk.p_len_l), dtype),
        lambda_d_blk=jnp.zeros((n_bins, ad.m_a), dtype),
        ad_blk=jnp.asarray(ad_blk, dtype),
        update_switch=jnp.asarray(1, jnp.int32),
        a_warm=jnp.asarray(a0, dtype),
        adapt_on=jnp.asarray(True),
    )
