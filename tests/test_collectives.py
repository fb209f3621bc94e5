"""Compiled-HLO collective audit (parallel/collectives_audit): regression
gates on what each parallel program is allowed to move over the
interconnect."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from se_snmf_nat_tpu.parallel.collectives_audit import (
    audit_compiled, collectives_in_hlo)
from se_snmf_nat_tpu.parallel.mesh import data_sharding, make_mesh


def test_hlo_parser_sizes():
    hlo = """
  %ar = f32[64,13]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = (f64[8]{0}, f32[2,2]{1,0}) all-gather(%y, %z), dim=0
  %done = f32[64,13]{1,0} all-reduce-done(%ar)
  %mm = f32[64,13]{1,0} dot(%a, %b)
"""
    rep = collectives_in_hlo(hlo)
    assert rep.count == 2                       # -done carries no bytes
    assert rep.ops[0]["bytes"] == 64 * 13 * 4
    assert rep.ops[1]["bytes"] == 8 * 8 + 4 * 4


@pytest.mark.slow
def test_train_step_single_fused_allreduce():
    """The distributed MU train step must psum exactly ONE fused buffer
    per loop body: (F,R) + (R,) sufficient statistics — anything more is
    a scaling regression."""
    from se_snmf_nat_tpu.parallel.train_step import (
        make_distributed_train_step)

    mesh = make_mesh((8, 1))
    f, r, t = 64, 16, 64
    rng = np.random.default_rng(0)
    step = make_distributed_train_step(mesh, n_iter=3)
    v = jax.device_put(jnp.asarray(rng.random((f, t)) + 0.01),
                       NamedSharding(mesh, P(None, "data")))
    h = jax.device_put(jnp.asarray(rng.random((r, t)) + 0.01),
                       NamedSharding(mesh, P(None, "data")))
    w = jax.device_put(jnp.asarray(rng.random((f, r)) + 0.01),
                       NamedSharding(mesh, P()))
    rep = audit_compiled(step, v, w, h)
    assert rep.count == 1, rep.ops
    itemsize = 8 if jax.config.jax_enable_x64 else 4
    assert rep.total_bytes == (f * r + r) * itemsize, rep.ops


def _dp_block_audit(reference_bases, x, dft_matmul):
    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer

    speech, noise = reference_bases
    mesh = make_mesh((8, 1))
    enh = SnmfEnhancer(default_config(), speech.b_dft, noise.b_dft,
                       speech.b_dft, noise.b_dft, dtype=jnp.float32,
                       block_adapt=16, frame_bucket=16, block_iter_cap=20,
                       block_fixed_iter=True, dft_matmul=dft_matmul)
    frames = enh._pad_frames(enh.frames_for(x[:4800]))
    batch = jax.device_put(
        jnp.asarray(np.stack([frames] * 8), jnp.float32),
        data_sharding(mesh, 3, 0))
    states = jax.tree.map(
        lambda a: jax.device_put(jnp.broadcast_to(a, (8,) + a.shape),
                                 data_sharding(mesh, a.ndim + 1, 0)),
        enh.initial_state())
    tv = jax.device_put(jnp.full((8,), frames.shape[0], jnp.int32),
                        data_sharding(mesh, 1, 0))
    return audit_compiled(enh._block_run_batch, batch, states, enh.win, tv)


@pytest.mark.slow
def test_dp_enhance_production_plan_collective_free(reference_bases,
                                                    m03_wav):
    """The PRODUCTION DP batch program (dft_matmul=True, as headline.py)
    may move only the while-loop sync preds over the mesh (single BYTES
    per step) — data-parallel enhancement must never grow real
    collectives.  This is a load-bearing property of the matmul DFT:
    matmul transforms partition over the lane axis like everything else,
    whereas GSPMD cannot shard the FFT over the batch axis (next test)."""
    x, _ = m03_wav
    rep = _dp_block_audit(reference_bases, x, dft_matmul=True)
    assert rep.total_bytes <= 16, rep.ops       # sync preds only


@pytest.mark.slow
def test_dp_enhance_fft_path_gathers(reference_bases, m03_wav):
    """Documented behavior, not a target: with jnp.fft transforms GSPMD
    all-gathers the full (B,T,fft) batch to run the FFT replicated
    (~3.1 MB per call at this toy shape) — measured here so a future JAX
    that learns to shard FFTs flips this test and we notice."""
    x, _ = m03_wav
    rep = _dp_block_audit(reference_bases, x, dft_matmul=False)
    gathers = [o for o in rep.ops if o["op"] == "all-gather"]
    assert gathers, rep.ops
    assert rep.total_bytes > 1_000_000, rep.ops
