"""Distributed sparse-NMF training step (multi-chip dictionary learning).

The reference trains dictionaries with a single-process MU loop over a
513 x ~72k spectrogram (run_basis_train.m:84-95).  Here one MU step is
written with shard_map over a ('data', 'model') mesh:

  V (F, T)  — frames sharded over 'data' (T axis), rows replicated
  W (F, R)  — columns sharded over 'model' (trivial axis on small ranks)
  H (R, T)  — R over 'model', T over 'data'

The H update is embarrassingly parallel in T.  The W update needs the
T-contractions  (V/Λ)Hᵀ  and the column sums of H — those are psum'd over
'data' (sufficient-statistic merges; the only cross-device traffic,
2·F·R floats per step).  Normalization coupling terms are computed on the
merged statistics so the result is identical to the single-chip update.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from se_snmf_nat_tpu.nmf.solver import normalize_columns


def _kl_mu_step_local(v, w, h, sparsity, flr, axis: str | None):
    """One KL MU step on local shards; psum over `axis` for W statistics."""
    prec = lax.Precision.HIGHEST
    lamb = jnp.maximum(jnp.matmul(w, h, precision=prec), flr)

    # H update (local in T)
    dph = jnp.maximum(jnp.sum(w, axis=0)[:, None] + sparsity, flr)
    dmh = jnp.matmul(w.T, v / lamb, precision=prec)
    h = h * dmh / dph
    lamb = jnp.maximum(jnp.matmul(w, h, precision=prec), flr)

    # W update — T-contractions need the global sums
    c_local = jnp.matmul(v / lamb, h.T, precision=prec)   # (F, R)
    sumh_local = jnp.sum(h, axis=1)                       # (R,)
    if axis is not None:
        c = lax.psum(c_local, axis)
        sumh = lax.psum(sumh_local, axis)
    else:
        c, sumh = c_local, sumh_local
    corr_p = jnp.sum(c * w, axis=0)
    dpw = jnp.maximum(sumh[None, :] + corr_p[None, :] * w, flr)
    dmw = c + (sumh * jnp.sum(w, axis=0))[None, :] * w
    w = w * dmw / dpw
    w, _ = normalize_columns(w)
    return w, h


def distributed_mu_step(v, w, h, *, sparsity: float = 5.0, flr: float = 1e-9,
                        mesh: Mesh | None = None):
    """One data-parallel KL MU step.  With a mesh, runs under shard_map with
    V/H sharded over 'data'; without, runs the identical single-chip math."""
    if mesh is None:
        return _kl_mu_step_local(v, w, h, sparsity, flr, axis=None)

    step = partial(_kl_mu_step_local, sparsity=sparsity, flr=flr, axis="data")
    fn = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(None, "data"), P(), P(None, "data")),
        out_specs=(P(), P(None, "data")),
    )
    return fn(v, w, h)


def make_distributed_train_step(mesh: Mesh, n_iter: int = 1,
                                sparsity: float = 5.0, flr: float = 1e-9):
    """Jitted n-iteration training step with explicit shardings."""
    vh_sharding = NamedSharding(mesh, P(None, "data"))
    w_sharding = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(vh_sharding, w_sharding, vh_sharding),
             out_shardings=(w_sharding, vh_sharding))
    def train_step(v, w, h):
        def body(_, wh):
            w, h = wh
            return distributed_mu_step(v, w, h, sparsity=sparsity, flr=flr,
                                       mesh=mesh)
        return lax.fori_loop(0, n_iter, body, (w, h))

    return train_step
