"""MultiStreamSession: lockstep fleet vs B independent StreamingSessions —
per-lane outputs must be bit-identical (vmap only adds a batch axis)."""

from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu.stream.serving import MultiStreamSession
from se_snmf_nat_tpu.stream.streaming import StreamingSession


@pytest.fixture(scope="module")
def enh():
    cfg = default_config()
    cfg = cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        adapt=replace(cfg.adapt, r_a=4, m_a=10),
        nmf=replace(cfg.nmf, max_iter=6),
    )
    rng = np.random.default_rng(0)
    f = cfg.signal.n_bins
    bx = rng.random((f, 8)) + 1e-3
    bd = rng.random((f, 8)) + 1e-3
    return SnmfEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64,
                        matlab_ad_blk_init=False)


def _lanes(m03_wav, n, length):
    x = m03_wav[0]
    rng = np.random.default_rng(7)
    lanes = [x[:length].astype(np.float64)]
    for _ in range(n - 1):
        lanes.append(rng.standard_normal(length) * 2000.0)
    return np.stack(lanes)


@pytest.mark.slow
def test_fleet_matches_independent_sessions(enh, m03_wav):
    xs = _lanes(m03_wav, 3, 12000)
    fleet = MultiStreamSession(enh, 3)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    for i in range(3):
        sess = StreamingSession(enh)
        want = np.concatenate([sess.push(xs[i]), sess.flush()])
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.slow
def test_fleet_block_mode_matches_single(enh, m03_wav):
    xs = _lanes(m03_wav, 2, 12000)
    fleet = MultiStreamSession(enh, 2, block_frames=8)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    sess = StreamingSession(enh, block_frames=8)
    want = np.concatenate([sess.push(xs[0]), sess.flush()])
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.slow
def test_fleet_irregular_lockstep_chunks(enh, m03_wav):
    """Chunked pushes with non-hop-aligned sizes give the same streams as
    one big lockstep push."""
    xs = _lanes(m03_wav, 2, 8000)
    want = MultiStreamSession(enh, 2)
    w = np.concatenate([want.push(xs), want.flush()], axis=1)
    fleet = MultiStreamSession(enh, 2)
    rng = np.random.default_rng(3)
    parts = []
    i = 0
    while i < xs.shape[1]:
        n = int(rng.integers(1, 700))
        parts.append(fleet.push(xs[:, i: i + n]))
        i += n
    parts.append(fleet.flush())
    got = np.concatenate([p for p in parts if p.shape[1]], axis=1)
    np.testing.assert_array_equal(got, w)


@pytest.mark.slow
def test_fleet_block_adaptive_matches_single(enh, m03_wav):
    xs = _lanes(m03_wav, 2, 12000)
    fleet = MultiStreamSession(enh, 2, block_frames=8,
                               use_block_adaptive=True)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    sess = StreamingSession(enh, block_frames=8, use_block_adaptive=True)
    want = np.concatenate([sess.push(xs[0]), sess.flush()])
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.slow
def test_fleet_samples_wire_matches_frames_wire(enh, m03_wav):
    """wire='samples' (raw hops up, in-graph framing/OLA/int16-write, PCM
    down — the transfer-optimal serving plan) equals the frames wire
    bit-for-bit at quantize=True, including the flush fallback."""
    xs = _lanes(m03_wav, 3, 12000)
    ref = MultiStreamSession(enh, 3, block_frames=8)
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    fleet = MultiStreamSession(enh, 3, block_frames=8, wire="samples")
    g = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_fleet_samples_wire_irregular_chunks(enh, m03_wav):
    xs = _lanes(m03_wav, 2, 8000)
    ref = MultiStreamSession(enh, 2, block_frames=4)
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    fleet = MultiStreamSession(enh, 2, block_frames=4, wire="samples")
    rng = np.random.default_rng(5)
    parts = []
    i = 0
    while i < xs.shape[1]:
        n = int(rng.integers(1, 700))
        parts.append(fleet.push(xs[:, i: i + n]))
        i += n
    parts.append(fleet.flush())
    g = np.concatenate([p for p in parts if p.shape[1]], axis=1)
    np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_fleet_samples_wire_reset_lanes(enh, m03_wav):
    """Mid-session tenant swap on the samples wire: the device queue/acc
    re-seed from host after reset_lanes, matching the frames wire."""
    xs = _lanes(m03_wav, 2, 12000)
    s = enh.cfg.signal
    blk = 4 * s.frameshift                  # one full block of samples
    outs = {}
    for wire in ("frames", "samples"):
        fleet = MultiStreamSession(enh, 2, block_frames=4, wire=wire)
        chunks = [fleet.push_per_lane(xs[:, :4 * blk])]
        fleet.reset_lanes([1])
        chunks.append(fleet.push_per_lane(xs[:, 4 * blk: 8 * blk]))
        outs[wire] = [np.concatenate([c[i] for c in chunks])
                      for i in range(2)]
    for i in range(2):
        np.testing.assert_array_equal(outs["samples"][i], outs["frames"][i])


@pytest.mark.slow
def test_fleet_pipelined_ticks_match(enh, m03_wav):
    """pipeline_ticks (push returns the previous tick while the current is
    in flight) yields the same total stream once flushed — values
    identical, emission lagged one block."""
    xs = _lanes(m03_wav, 2, 12000)
    ref = MultiStreamSession(enh, 2, block_frames=8)
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    fleet = MultiStreamSession(enh, 2, block_frames=8, wire="samples",
                               pipeline_ticks=True)
    first = fleet.push(xs)
    # lag: the pipelined session owes at least one block vs the reference
    assert first.shape[1] < w.shape[1]
    g = np.concatenate([first, fleet.flush()], axis=1)
    np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_fleet_mesh_sharded_samples_wire(enh, m03_wav):
    """Samples wire + lane sharding over a device mesh (multi-chip
    serving): device-resident queue/acc shard over 'data' and the output
    matches the unsharded samples-wire session."""
    from se_snmf_nat_tpu.parallel.mesh import make_mesh

    xs = _lanes(m03_wav, 8, 8000)
    ref = MultiStreamSession(enh, 8, block_frames=4, wire="samples")
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    mesh = make_mesh((8, 1))
    fleet = MultiStreamSession(enh, 8, block_frames=4, wire="samples",
                               mesh=mesh)
    g = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    np.testing.assert_array_equal(g, w)


def test_pipeline_requires_samples_wire(enh):
    with pytest.raises(ValueError):
        MultiStreamSession(enh, 2, block_frames=8, pipeline_ticks=True)


def test_fleet_push_shape_check(enh):
    fleet = MultiStreamSession(enh, 2)
    with pytest.raises(ValueError):
        fleet.push(np.zeros(100))


def test_serving_capacity_mechanics(enh):
    from se_snmf_nat_tpu.runtime.profiling import measure_serving_capacity
    rep = measure_serving_capacity(enh, fleet_sizes=(1, 2),
                                   block_frames_grid=(4,), n_ticks=3)
    blk = rep["blocks"][0]
    assert blk["deadline_ms"] == 40.0
    assert [r["fleet"] for r in blk["table"]] == [1, 2]
    assert all(r["tick_ms"] > 0 for r in blk["table"])
    assert rep["wire"] == "samples"


@pytest.mark.slow
def test_fleet_mesh_sharded_matches_unsharded(enh, m03_wav):
    """Lanes sharded over a 4-device 'data' mesh: same program partitioned
    by GSPMD, so outputs must match the single-device fleet bit-for-bit."""
    import jax
    from se_snmf_nat_tpu.parallel.mesh import make_mesh
    xs = _lanes(m03_wav, 4, 8000)
    plain = MultiStreamSession(enh, 4)
    want = np.concatenate([plain.push(xs), plain.flush()], axis=1)
    mesh = make_mesh(devices=jax.devices()[:4], shape=(4, 1))
    fleet = MultiStreamSession(enh, 4, mesh=mesh)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    np.testing.assert_array_equal(got, want)


def test_fleet_mesh_divisibility_check(enh):
    import jax
    from se_snmf_nat_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(devices=jax.devices()[:4], shape=(4, 1))
    with pytest.raises(ValueError):
        MultiStreamSession(enh, 3, mesh=mesh)


def test_push_diverged_raises_before_mutation(enh):
    """Clock-divergence check runs BEFORE processing (review finding): the
    raising push consumes nothing, so push_per_lane afterwards produces
    exactly what it would have without the failed call."""
    s = enh.cfg.signal
    rng = np.random.default_rng(3)
    hops = np.round(rng.standard_normal((2, s.frameshift)) * 1000.0)
    fleet = MultiStreamSession(enh, 2)
    fleet.push(hops)
    fleet.reset_lanes([0])                     # lane clocks now diverge
    want = MultiStreamSession(enh, 2)
    want.push(hops)
    want.reset_lanes([0])
    with pytest.raises(ValueError, match="diverged"):
        fleet.push(hops)
    got = fleet.push_per_lane(hops)            # state untouched by the raise
    ref = want.push_per_lane(hops)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_reset_lanes_rejects_partial_hold(enh):
    """A fleet-wide sample hold cannot be reset per lane; zero-filling it
    would prepend silence to the new tenant (review finding) — reject."""
    s = enh.cfg.signal
    fleet = MultiStreamSession(enh, 2)
    fleet.push(np.ones((2, s.frameshift + 3)))   # leaves a 3-sample hold
    with pytest.raises(RuntimeError, match="hold"):
        fleet.reset_lanes([0])


@pytest.mark.slow
def test_fleet_dft_matmul_matches_single(enh, m03_wav):
    """dft_matmul propagates into the fleet program (review finding): a
    fleet over a dft_matmul=True enhancer must match the solo streaming
    session of the same enhancer bit-for-bit."""
    enh_dm = SnmfEnhancer(enh.cfg, *enh._bases, dtype=enh.dtype,
                          matlab_ad_blk_init=False, dft_matmul=True)
    xs = _lanes(m03_wav, 2, 12000)
    fleet = MultiStreamSession(enh_dm, 2, block_frames=8)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    sess = StreamingSession(enh_dm, block_frames=8)
    want = np.concatenate([sess.push(xs[0]), sess.flush()])
    np.testing.assert_array_equal(got[0], want)
    # the headline plan's per-direction precision knobs propagate the
    # same way (analysis 'high' / synthesis 'default' — see headline.py).
    # On the CPU backend lax matmul precision strings are no-ops (every
    # tier is the same native math — here f64 under the x64 conftest), so
    # value-identity with the run above holds REGARDLESS of whether the
    # sessions actually read the knobs; the structural propagation is
    # asserted directly below instead.
    enh_hp = SnmfEnhancer(enh.cfg, *enh._bases, dtype=enh.dtype,
                          matlab_ad_blk_init=False, dft_matmul=True,
                          dft_precision="high", idft_precision="default")
    assert (enh_hp.dft_precision, enh_hp.idft_precision) == (
        "high", "default")   # the attributes the sessions read via getattr
    fleet_hp = MultiStreamSession(enh_hp, 2, block_frames=8)
    got_hp = np.concatenate([fleet_hp.push(xs), fleet_hp.flush()], axis=1)
    sess_hp = StreamingSession(enh_hp, block_frames=8)
    want_hp = np.concatenate([sess_hp.push(xs[0]), sess_hp.flush()])
    np.testing.assert_array_equal(got_hp[0], want_hp)
    np.testing.assert_array_equal(got_hp, got)


@pytest.mark.slow
def test_per_lane_adaptation_toggle(enh, m03_wav):
    """Serving-fleet push-to-talk: toggling ONE lane off freezes only that
    lane's dictionary; the other lanes' heads keep adapting and their
    outputs stay identical to an untouched fleet."""
    from se_snmf_nat_tpu.stream.serving import MultiStreamSession
    x = m03_wav[0][:16000]
    xs = np.stack([x, np.roll(x, 1000), np.roll(x, 2000)])
    ref = MultiStreamSession(enh, 3, block_frames=4)
    out_ref = [ref.push(xs)]
    toggled = MultiStreamSession(enh, 3, block_frames=4)
    out_tog = [toggled.push(xs)]
    np.testing.assert_array_equal(out_tog[0], out_ref[0])
    toggled.set_adaptation(False, lanes=[1])
    h_frozen = np.asarray(toggled.state.b_d_head[1])
    xs2 = np.stack([np.roll(x, 3000), np.roll(x, 4000), np.roll(x, 5000)])
    out_ref.append(ref.push(xs2))
    out_tog.append(toggled.push(xs2))
    # lane 1 frozen, lanes 0/2 bit-identical to the untouched fleet
    np.testing.assert_array_equal(np.asarray(toggled.state.b_d_head[1]),
                                  h_frozen)
    assert not np.array_equal(np.asarray(ref.state.b_d_head[1]), h_frozen)
    for lane in (0, 2):
        np.testing.assert_array_equal(out_tog[1][lane], out_ref[1][lane])
        np.testing.assert_array_equal(
            np.asarray(toggled.state.b_d_head[lane]),
            np.asarray(ref.state.b_d_head[lane]))
    # re-enable: lane 1 adapts again
    toggled.set_adaptation(True, lanes=[1])
    toggled.push(np.stack([x, x, x]))
    assert not np.array_equal(np.asarray(toggled.state.b_d_head[1]),
                              h_frozen)


# ---------------------------------------------------------------------------
# ShardedFleet: the product form of the sharded serving ceiling
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sharded_fleet_matches_single_session(enh, m03_wav):
    """N sub-fleet programs over lane slices == one MultiStreamSession,
    bit-for-bit, on the samples wire with pipelining (the deployment
    shape the SERVING ceiling row measures)."""
    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    xs = _lanes(m03_wav, 4, 12000)
    ref = MultiStreamSession(enh, 4, block_frames=8, wire="samples")
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    fleet = ShardedFleet(enh, 4, sub_fleets=2, block_frames=8,
                         wire="samples", pipeline_ticks=True)
    g = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_sharded_fleet_lane_lifecycle_routes_globally(enh, m03_wav):
    """reset_lanes / zero_queue_rows / set_adaptation with GLOBAL lane
    indices land on the right shard: outputs equal the unsharded fleet
    run through the identical lifecycle."""
    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    xs = _lanes(m03_wav, 4, 9600)
    s = enh.cfg.signal
    blk = 4 * s.frameshift
    outs = {}
    for make in (lambda: MultiStreamSession(enh, 4, block_frames=4,
                                            wire="samples"),
                 lambda: ShardedFleet(enh, 4, sub_fleets=2, block_frames=4,
                                      wire="samples")):
        fleet = make()
        chunks = [fleet.push_per_lane(xs[:, :4 * blk])]
        chunks.append(fleet.set_adaptation(False, lanes=[1, 3]))
        fleet.reset_lanes([2])          # lane 2 = shard 1, local 0
        chunks.append(fleet.push_per_lane(xs[:, 4 * blk: 8 * blk]))
        outs[type(fleet).__name__] = [
            np.concatenate([c[i] for c in chunks]) for i in range(4)]
    for i in range(4):
        np.testing.assert_array_equal(outs["ShardedFleet"][i],
                                      outs["MultiStreamSession"][i])


def test_sharded_fleet_validates_divisibility(enh):
    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    with pytest.raises(ValueError):
        ShardedFleet(enh, 5, sub_fleets=2)
    fleet = ShardedFleet(enh, 4, sub_fleets=2)
    with pytest.raises(ValueError):
        fleet.reset_lanes([4])


@pytest.mark.slow
def test_server_sub_fleets_bit_parity(enh, m03_wav):
    """EnhanceServer over a ShardedFleet serves the same bytes as over a
    MultiStreamSession (the cli serve --sub-fleets path)."""
    import asyncio

    from se_snmf_nat_tpu.runtime.server import (EnhanceServer,
                                                enhance_over_socket)

    xs = _lanes(m03_wav, 2, 8000)

    async def run(sub_fleets):
        srv = EnhanceServer(enh, n_lanes=4, block_frames=4,
                            sub_fleets=sub_fleets)
        await srv.start()
        try:
            outs = await asyncio.gather(*[
                enhance_over_socket(srv.host, srv.port,
                                    xs[i % 2].astype(np.int16))
                for i in range(4)])
        finally:
            await srv.stop()
        return outs

    a = asyncio.run(run(1))
    b = asyncio.run(run(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_serving_product_path_mechanics(enh):
    from se_snmf_nat_tpu.runtime.profiling import (
        measure_serving_product_path)
    rep = measure_serving_product_path(enh, plans=((1, 2), (2, 2)),
                                       block_frames=4, n_ticks=3)
    assert rep["deadline_ms"] == 40.0
    assert [r["total_streams"] for r in rep["table"]] == [2, 4]
    assert all(r["tick_ms"] > 0 for r in rep["table"])
    assert rep["pipeline_ticks"] is True


@pytest.mark.slow
def test_sharded_fleet_block_adaptive_matches_single(enh, m03_wav):
    """ShardedFleet with the block-adaptive step (frames wire) equals the
    unsharded block-adaptive fleet — the throughput serving mode also
    shards."""
    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    xs = _lanes(m03_wav, 4, 12000)
    ref = MultiStreamSession(enh, 4, block_frames=8,
                             use_block_adaptive=True)
    w = np.concatenate([ref.push(xs), ref.flush()], axis=1)
    fleet = ShardedFleet(enh, 4, sub_fleets=2, block_frames=8,
                         use_block_adaptive=True)
    g = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    np.testing.assert_array_equal(g, w)
