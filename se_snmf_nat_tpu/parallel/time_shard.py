"""Time-axis (sequence/context) parallel enhancement.

The reference handles long audio by streaming with bounded state (SURVEY §5
'Long-context'): every temporal recurrence — DD-smoothed noise PSD
lambda_dav (alpha_d decay), the MMSE prior xm_tilde (1 frame), the
block-sparsity ring r_blk (P_len_l frames), the adaptation rings (m_a
frames) — forgets geometrically or has a fixed window.  That bounded memory
is exactly what makes the time axis shardable: split a long spectrogram
into D contiguous segments, give each device its segment PLUS a `halo` of
preceding warm-up frames, scan locally from the fresh initial state, and
drop the halo outputs.  The halo plays the carry-in role of a ring exchange
(one-directional context parallelism); with adaptation off the state memory
is ~P_len_l + O(1/log alpha_d) frames, so a modest halo reproduces the
sequential scan to quantization exactness, and with online adaptation on
the divergence is bounded by the dictionary drift inside one halo (tests
measure both).

Mechanics: shard_map over the mesh 'data' axis; each device runs the SAME
jitted per-shard scan (engine step + masked validity), so the compiled
executable is shared and the only communication is the host-side gather of
outputs — zero collectives in the hot loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from se_snmf_nat_tpu.dsp.stft import analysis_frames, overlap_add, synthesis_frames
from se_snmf_nat_tpu.io.wavio import enhanced_quantize


def _shard_plan(t: int, n_shards: int, halo: int) -> tuple[int, np.ndarray]:
    """Segment length (padded) and per-shard start offsets into the padded
    frame array (offsets point at the halo start)."""
    seg = -(-t // n_shards)
    starts = np.arange(n_shards) * seg
    return seg, starts


def enhance_time_sharded(enhancer, x: np.ndarray, mesh: Mesh, *,
                         halo: int = 384, quantize: bool = True) -> np.ndarray:
    """Enhance one long utterance with its frame axis sharded over
    mesh('data').

    enhancer: a stream.pipeline.SnmfEnhancer (its engine/step/windows are
    reused); x: int16-scale samples.  Returns the enhanced samples with the
    same emit trim as the sequential path.

    Halo default: 384 frames.  A sweep on the previous accelerator (8
    shards, f32, adaptation on) measured golden corr vs halo on both
    fixtures:

        halo      64      128     192     256     384   (gate .993)
        M03     .99288  .99231  .99720  .99704  .99686
        LM_in   .96361  .98146  .99346  .98930  .99737

    The drift envelope is NON-monotonic below ~192 (the adaptation
    trajectory is chaotic in the warm-up), clears the gate at 192 with a
    thin LM margin (.0005), and holds >=.004 margin on both fixtures at
    384, so 384 ships.  Cost: halo frames are redundant compute per shard
    — ~12% of an 8-shard LM_in-length segment; on utterances shorter than
    halo*shards the warm-up clamps to the stream start and shards degrade
    gracefully toward replicated-sequential work (correct, just not
    parallel — time sharding is a LONG-utterance plan).  Gated in
    tests/test_time_shard.py against the full fixture.
    """
    cfg = enhancer.cfg
    s = cfg.signal
    eng = enhancer.engine
    dtype = enhancer.dtype
    n_shards = mesh.devices.size

    frames_np = enhancer.frames_for(x)
    t = frames_np.shape[0]
    seg, starts = _shard_plan(t, n_shards, halo)

    # shard windows, all (halo+seg) frames wide: shard 0 starts at frame 0
    # with NO warm-up (keeping the reference's init_N_len gating aligned to
    # the true stream start — shard 0 is bit-faithful to the sequential
    # path), shards i>0 start `halo` frames early.  The scan is causal, so
    # warm-up/overhang frames never corrupt a shard's own segment outputs.
    width = halo + seg
    pad_total = n_shards * seg + halo
    padded = np.concatenate(
        [frames_np, np.zeros((max(pad_total - t, 0), s.framelength))], axis=0)
    halo_lens = np.minimum(starts, halo)   # 0 for shard 0; clamps tiny segs
    shard_frames = np.stack(
        [padded[st - h: st - h + width]
         for st, h in zip(starts, halo_lens)])            # (D, width, L)
    valid = np.minimum(np.maximum(t - starts, 0), seg)    # frames per shard

    win = enhancer.win
    state0 = enhancer.initial_state()

    def run_shard(frames):
        frames = frames[0]          # shard_map passes (1, width, L)
        mag, phase = analysis_frames(frames, win, s.fftlength, s.pow,
                                     s.dc_bin, s.nonzerofloor, s.preemph)
        ls = jnp.arange(1, mag.shape[0] + 1, dtype=jnp.int32)
        _, xm = jax.lax.scan(eng.step, state0, (mag, ls))
        out_frames = synthesis_frames(xm, phase, s.framelength, s.fftlength,
                                      win, s.pow, s.dc_bin_back,
                                      s.overlapscale, s.preemph)
        return overlap_add(out_frames, s.frameshift)[None]

    # check_vma off: the shard body is collective-free (pure local scan),
    # and the solver's while_loop constants would otherwise need pvary
    # plumbing through every carry
    sharded = jax.jit(jax.shard_map(
        run_shard, mesh=mesh,
        in_specs=(P("data", None, None),),
        out_specs=P("data", None), check_vma=False))

    frames_dev = jax.device_put(
        jnp.asarray(shard_frames, dtype),
        NamedSharding(mesh, P("data", None, None)))
    olas = np.asarray(sharded(frames_dev))

    # stitch: from each shard's OLA stream take its segment samples after
    # the warm-up; frame k of a shard begins at k*shift in its local stream.
    hop = s.frameshift
    pieces = []
    for i in range(n_shards):
        if valid[i] <= 0:
            continue
        lo = int(halo_lens[i]) * hop
        pieces.append(olas[i, lo: lo + int(valid[i]) * hop])
    y = np.concatenate(pieces)[: t * hop]

    start = cfg.delay * hop
    emit = y[start: start + (t - cfg.delay) * hop]
    return enhanced_quantize(emit) if quantize else emit
