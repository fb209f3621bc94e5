"""Tracing / metrics (SURVEY §5 'Tracing / profiling').

The reference had tic/toc around the GPU solver and per-iteration objective
prints.  Here:

  * ``trace(dir)``       — context manager around jax.profiler.trace; open
                           the dump with TensorBoard/XProf to see per-op
                           device timelines.
  * ``StageTimer``       — named wall-clock stages with audio-second
                           accounting; renders the per-stage
                           audio-seconds/s table the BASELINE metric asks
                           for.
  * ``annotate(name)``   — jax.profiler.TraceAnnotation passthrough so
                           pipeline stages show up named in traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str):
    import jax

    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    import jax

    return jax.profiler.TraceAnnotation(name)


@dataclass
class StageTimer:
    """Accumulates wall time per named stage plus processed audio seconds."""

    stages: dict = field(default_factory=dict)
    audio_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> dict:
        out = {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.total, 4),
            "audio_seconds_per_s": round(
                self.audio_seconds / self.total, 2) if self.total else 0.0,
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
        }
        return out

    def json(self) -> str:
        return json.dumps(self.report())


def measure_serving_capacity(enh, fleet_sizes=(1, 8, 32, 64, 128, 256),
                             block_frames_grid=(8, 16),
                             n_ticks: int = 30,
                             wire: str = "samples") -> dict:
    """Largest lockstep fleet that still meets the real-time deadline.

    For each (block_frames, fleet size B), drives a MultiStreamSession
    (stream/serving.py) with ``block_frames``-hop ticks of synthetic audio
    and records the median per-tick wall time.  A fleet is real-time when
    one tick completes inside its own audio duration (block_frames x
    10 ms) — larger blocks trade added latency (bounded by the block) for
    fewer dispatches and bigger transfers, so the report carries the full
    grid: capacity per latency tier, not just one max.

    ``wire='samples'`` uses the transfer-optimal tick (raw hops up, int16
    PCM down, ~16x less wire traffic than the frames wire).
    """
    import numpy as np

    from se_snmf_nat_tpu.stream.serving import MultiStreamSession

    s = enh.cfg.signal
    rng = np.random.default_rng(0)
    blocks = []
    # (block_frames, pipelined) grid: pipelining overlaps the PCM fetch of
    # tick n-1 with tick n's upload+compute (one extra block of latency,
    # so its effective end-to-end latency tier is ~2 blocks)
    grid = [(bf, False) for bf in block_frames_grid]
    if wire == "samples":
        grid.append((block_frames_grid[0], True))
    for bf, pipelined in grid:
        tick_samples = bf * s.frameshift
        deadline_ms = tick_samples / s.fs * 1e3
        rows = []
        for b in fleet_sizes:
            fleet = MultiStreamSession(enh, b, block_frames=bf, wire=wire,
                                       pipeline_ticks=pipelined)
            # integer-valued synthetic audio: real captures are int16
            # PCM, which the samples wire uploads at 2 bytes/sample
            x = np.rint(rng.standard_normal((b, tick_samples)) * 2000.0)
            for _ in range(3):                      # compile + warm
                fleet.push(x)
            laps = []
            for _ in range(n_ticks):
                t0 = time.perf_counter()
                fleet.push(x)
                laps.append(time.perf_counter() - t0)
            tick_ms = float(np.median(laps) * 1e3)
            rows.append({"fleet": int(b), "tick_ms": round(tick_ms, 2),
                         "real_time": bool(tick_ms < deadline_ms)})
        ok = [r["fleet"] for r in rows if r["real_time"]]
        blocks.append({"block_frames": bf, "pipelined": pipelined,
                       "deadline_ms": round(deadline_ms, 1),
                       "latency_blocks": 2 if pipelined else 1,
                       "max_real_time_fleet": max(ok) if ok else 0,
                       "table": rows})
    return {"wire": wire,
            "max_real_time_fleet": max(b["max_real_time_fleet"]
                                       for b in blocks),
            "blocks": blocks}


def _fleet_tick_window(enh, lanes: int, block_frames: int, n_inner: int,
                       rng, session=None):
    """One sub-fleet's chained-tick scan window — the shared core of both
    device-ceiling measurements (the microbenchmark protocol lives ONCE
    here: distinct inputs, carry chained window to window, scalar fetch to
    close).

    Builds one samples-wire MultiStreamSession of ``lanes`` lanes (or
    measures a caller-provided ``session`` — e.g. one ShardedFleet shard,
    so the program timed is the PRODUCT object's own compiled tick), jits
    a window of ``n_inner`` consecutive ticks inside one lax.scan (the
    carry chains queue/acc/state/l0 tick to tick, so a window is a single
    dispatch and XLA cannot elide ticks), compiles + warms it once, and
    returns ``(ticks, make_hops, carry)`` where ``ticks(hops, *carry) ->
    (carry', sums)`` and ``make_hops()`` draws a fresh distinct hop batch.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.stream.serving import MultiStreamSession

    s = enh.cfg.signal
    shift = s.frameshift
    fleet = session if session is not None else MultiStreamSession(
        enh, lanes, block_frames=block_frames, wire="samples")
    run = fleet._run_block_samples

    def make_hops():
        return jnp.asarray(
            np.rint(rng.standard_normal(
                (lanes, block_frames, shift)) * 2000.0), enh.dtype)

    l0 = jnp.ones((lanes,), jnp.int32)

    @jax.jit
    def ticks(hops, queue, acc, state, l0):
        def body(carry, _):
            queue, acc, state, l0 = carry
            pcm, queue, acc, state = run(hops, queue, acc, state, l0)
            return ((queue, acc, state, l0 + block_frames),
                    jnp.sum(pcm.astype(jnp.float32)))
        carry, sums = jax.lax.scan(
            body, (queue, acc, state, l0), None, length=n_inner)
        return carry, sums

    carry = (fleet._queue_dev, fleet._acc_dev, fleet.state, l0)
    carry, sums = ticks(make_hops(), *carry)      # compile + warm
    float(jnp.sum(sums))
    return ticks, make_hops, carry


def measure_serving_device_ceiling(enh, fleet_sizes=(128, 256, 384, 512),
                                   block_frames: int = 8,
                                   n_inner: int = 25) -> dict:
    """Compute-bound serving ceiling, host path EXCLUDED.

    measure_serving_capacity bounds what the host path can serve; this
    measures device compute alone: the samples-wire tick program (MultiStreamSession
    run_one_samples — framing, engine scan, iSTFT, OLA, int16-write, all
    in-graph) runs ``n_inner`` consecutive ticks inside ONE jitted
    lax.scan window (``_fleet_tick_window``), so wall/n_inner is pure
    device time per tick (no per-tick dispatch, no PCM fetch).  A fleet
    is compute-real-time when that device tick fits its own audio
    duration.
    """
    import numpy as np
    import jax.numpy as jnp
    import jax

    s = enh.cfg.signal
    shift = s.frameshift
    deadline_ms = block_frames * shift / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for b in fleet_sizes:
        ticks, make_hops, carry = _fleet_tick_window(
            enh, b, block_frames, n_inner, rng)
        hops = make_hops()
        laps = []
        for _ in range(3):
            t0 = time.perf_counter()
            carry, sums = ticks(hops, *carry)
            float(jnp.sum(sums))                          # closes window
            laps.append((time.perf_counter() - t0) / n_inner)
        tick_ms = min(laps) * 1e3
        rows.append({
            "fleet": int(b),
            "device_tick_ms": round(tick_ms, 2),
            "device_ms_per_lane": round(tick_ms / b, 4),
            "real_time": bool(tick_ms < deadline_ms)})
    ok = [r["fleet"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "max_compute_real_time_fleet": max(ok) if ok else 0,
            "note": "device compute only (single-dispatch scan over "
                    f"{n_inner} chained ticks)",
            "table": rows}


def measure_serving_device_ceiling_sharded(
        enh, shard_plans=((2, 128), (3, 96), (4, 80)),
        block_frames: int = 8, n_inner: int = 25) -> dict:
    """Compute-bound ceiling for a SHARDED fleet: N independent
    MultiStreamSession sub-fleets ticked back-to-back on one chip.

    Rationale: on the previous accelerator the single-program ceiling
    (measure_serving_device_ceiling) hit a residency cliff past 192 lanes,
    a working-set/tiling property of the ONE fused tick program, not of
    the device's throughput: smaller programs each keep the good tiling.
    Whether the H100 has such a cliff is not measured.
    A deployment realizes this by simply creating N sessions and ticking
    them in sequence — no new mechanism, each sub-fleet's outputs stay
    bit-identical to solo sessions.

    Methodology: ONE ``_fleet_tick_window`` per plan (all N shards share
    its executable — one compile per distinct lane count; lane counts not
    measured by the unsharded bench do compile fresh scan programs),
    per-shard carries and distinct per-shard inputs, and
    a lap dispatches all N shard windows asynchronously back-to-back
    before fetching any result — the device executes them serially,
    dispatch overhead hides under the previous window's execution, and
    wall/n_inner is the device time for one full-fleet round plus a
    residual of at most one window's dispatch (i.e. the number reported
    is a conservative UPPER bound on device time).

    r5: the deployment shape this measures IS a product mode now —
    ``stream/serving.ShardedFleet`` / ``cli serve --sub-fleets`` — and
    the program timed here is taken from a ShardedFleet shard's own
    compiled tick (``shards[0]._run_block_samples``), so the row is
    produced by the shipped code path under the device-ceiling
    methodology; ``measure_serving_product_path`` measures the same
    object end-to-end with the host path included.
    """
    import numpy as np
    import jax.numpy as jnp

    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    s = enh.cfg.signal
    shift = s.frameshift
    deadline_ms = block_frames * shift / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for n_shards, lanes in shard_plans:
        fleet = ShardedFleet(enh, n_shards * lanes, sub_fleets=n_shards,
                             block_frames=block_frames, wire="samples")
        ticks, make_hops, carry0 = _fleet_tick_window(
            enh, lanes, block_frames, n_inner, rng,
            session=fleet.shards[0])
        hops = [make_hops() for _ in range(n_shards)]
        # every shard starts from the same freshly-warmed carry (identical
        # initial session state); the distinct per-shard hop streams
        # diverge them from the first window on
        carries = [carry0] * n_shards
        laps = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs = []
            for i in range(n_shards):             # all windows in flight
                carries[i], sums = ticks(hops[i], *carries[i])
                outs.append(sums)
            for sums in outs:                     # then close the window
                float(jnp.sum(sums))
            laps.append((time.perf_counter() - t0) / n_inner)
        tick_ms = min(laps) * 1e3
        total = n_shards * lanes
        rows.append({
            "shards": int(n_shards), "lanes_per_shard": int(lanes),
            "total_streams": int(total),
            "device_round_ms": round(tick_ms, 2),
            "device_ms_per_lane": round(tick_ms / total, 4),
            "real_time": bool(tick_ms < deadline_ms)})
    ok = [r["total_streams"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "max_compute_real_time_streams": max(ok) if ok else 0,
            "shipped_program": True,
            "note": "N sub-fleet chained-scan windows dispatched "
                    f"back-to-back ({n_inner} rounds each, results "
                    "fetched only after all are in flight — reported "
                    "round time is an upper bound incl. at most one "
                    "window's dispatch residual); sidesteps the "
                    ">192-lane single-program residency cliff.  The "
                    "program timed is a ShardedFleet shard's own "
                    "compiled tick (the cli serve --sub-fleets object)",
            "table": rows}


def measure_hop_latency(enh, x: "np.ndarray", n_rep: int = 3,
                        n_calls: int = 60) -> dict:
    """Separate per-hop DEVICE compute from per-call DISPATCH overhead.

    The reference's real-time budget is one 10 ms hop per engine step
    (settings/initial_setting_SNMF_NAT.m:22-27).  A single-hop device call
    also carries dispatch overhead.  This measurement produces both
    numbers:

      * ``device_ms_per_hop`` — one dispatch runs the WHOLE utterance
        through the exact masked scan (stream/pipeline.py run); elapsed /
        n_frames is the true per-hop device compute (STFT + engine step +
        iSTFT), free of per-call overhead.
      * ``singlehop_wall_ms`` — median wall time of a block_frames=1
        StreamingSession device call on this bench.
      * ``dispatch_overhead_ms`` — their difference: what host dispatch
        costs per call.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.stream.streaming import StreamingSession

    s = enh.cfg.signal
    true_frames = enh.frames_for(np.asarray(x, np.float64))
    t_true = true_frames.shape[0]
    frames = jnp.asarray(enh._pad_frames(true_frames), enh.dtype)
    t_valid = jnp.asarray(t_true, jnp.int32)

    # distinct inputs per rep
    rng = np.random.default_rng(0)
    variants = [frames * jnp.asarray(1.0 + 1e-4 * rng.standard_normal(),
                                     enh.dtype) for _ in range(n_rep + 1)]
    y, _ = enh._run_masked(variants[-1], enh.initial_state(), t_valid)  # warm
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    for i in range(n_rep):
        y, _ = enh._run_masked(variants[i], enh.initial_state(), t_valid)
    jax.block_until_ready(y)
    # divide by EXECUTED steps: bucket-padding frames run the same masked
    # per-step compute, so per-hop cost is elapsed / padded count
    device_ms_per_hop = (time.perf_counter() - t0) / n_rep \
        / frames.shape[0] * 1e3

    sess = StreamingSession(enh, block_frames=1)
    hop = np.zeros(s.frameshift)
    sess.push(x[: s.frameshift * 4])            # warm the 1-hop executable
    laps = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        sess.push(hop, quantize=False)
        laps.append(time.perf_counter() - t0)
    singlehop_wall_ms = float(np.median(laps) * 1e3)

    hop_budget_ms = s.frameshift / s.fs * 1e3
    return {
        "device_ms_per_hop": round(device_ms_per_hop, 3),
        "singlehop_wall_ms": round(singlehop_wall_ms, 2),
        "dispatch_overhead_ms": round(
            singlehop_wall_ms - device_ms_per_hop, 2),
        "hop_budget_ms": round(hop_budget_ms, 1),
        "device_within_budget": bool(device_ms_per_hop < hop_budget_ms),
        "singlehop_within_budget_here": bool(
            singlehop_wall_ms < hop_budget_ms),
        "n_frames": int(t_true),
    }


def measure_serving_product_path(
        enh, plans=((1, 128), (1, 192), (2, 128), (3, 96), (4, 80)),
        block_frames: int = 8, n_ticks: int = 20,
        pipeline_ticks: bool = True) -> dict:
    """Real-time capacity through the SHIPPED serving path (VERDICT r4 #1).

    Unlike the device-ceiling harnesses (which jit chained tick windows to
    isolate device compute), this drives ``stream/serving.ShardedFleet``
    — the object ``cli serve --sub-fleets`` deploys — through its public
    ``push``: per-tick dispatch, the samples wire's PCM upload/download,
    and the host-side queue bookkeeping are all INCLUDED, so a row here is
    a capacity this process could actually serve.  ``pipeline_ticks``
    (the deployment default at scale) overlaps each shard's PCM fetch
    with the other shards' device compute.

    Inputs rotate across a pool of distinct integer hop batches.
    """
    import numpy as np

    from se_snmf_nat_tpu.stream.serving import ShardedFleet

    s = enh.cfg.signal
    tick_samples = block_frames * s.frameshift
    deadline_ms = tick_samples / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for n_shards, lanes in plans:
        total = n_shards * lanes
        fleet = ShardedFleet(enh, total, sub_fleets=n_shards,
                             block_frames=block_frames, wire="samples",
                             pipeline_ticks=pipeline_ticks)
        pool = [np.rint(rng.standard_normal(
            (total, tick_samples)) * 2000.0) for _ in range(4)]
        for i in range(3):                          # compile + warm
            fleet.push(pool[i % len(pool)])
        laps = []
        for i in range(n_ticks):
            t0 = time.perf_counter()
            fleet.push(pool[i % len(pool)])
            laps.append(time.perf_counter() - t0)
        tick_ms = float(np.median(laps) * 1e3)
        rows.append({
            "shards": int(n_shards), "lanes_per_shard": int(lanes),
            "total_streams": int(total),
            "tick_ms": round(tick_ms, 2),
            "tick_p90_ms": round(float(np.percentile(laps, 90) * 1e3), 2),
            "real_time": bool(tick_ms < deadline_ms)})
    ok = [r["total_streams"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "pipeline_ticks": bool(pipeline_ticks),
            "max_real_time_streams_shipped_path": max(ok) if ok else 0,
            "note": "ShardedFleet.push end to end (dispatch + host "
                    "transfers + device); the device_ceiling rows bound "
                    "the device alone",
            "table": rows}
