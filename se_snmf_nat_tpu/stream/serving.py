"""Multi-stream serving session: B concurrent real-time streams, one
device program.

The reference's live path serves exactly one stream per MATLAB process
(GUI mic loop SE_GUI.m:372-516; filewise queue filewise_run_IS16.m:102-169).
An accelerator at these model sizes is grossly underutilized by one
stream, so the serving plan batches a fleet: every lane is an independent
stream (its own engine state, OLA chain and output), but each hop tick runs
ONE vmapped device call for all lanes — the matrix units see (B·K)-wide
GEMM batches instead of K-wide, and the per-call dispatch cost is paid once
per fleet, not per stream.

Lanes advance in lockstep on a shared hop clock (the natural shape for a
fixed fleet of channels sampled at the same rate — multi-mic rigs, call
decoding farms).  Per-lane outputs are bit-identical to running B separate
StreamingSessions at x64 (CI-gated — vmap only adds a batch axis to the
same jitted program).  At f32 on an accelerator the batched GEMMs round
differently from single-lane ones (TF32 on the H100 at the default
precision), which the adaptive dictionary recursion amplifies along the
documented trajectory-divergence envelope (see enhance/engine.py on
conv_eps trajectory sensitivity; chip_smoke.py's serve phase compares
server lanes with solo sessions on the card).

Capacity: ``bench --serving`` measures the largest lockstep fleet whose
per-tick wall time still meets the real-time deadline.  Not measured on
the H100.

Wire formats: ``wire='frames'`` ships (B, K, framelength) float frames
both ways (simple, host-side OLA); ``wire='samples'`` uploads raw int16
hop samples, shifts the frame queue / overlap-adds / applies the MATLAB
int16-write IN-GRAPH against device-resident per-lane state, and
downloads int16 PCM — ~16x less wire traffic per tick, bit-identical
(partial blocks, flush, and lane resets fall back to the frames path with
a one-shot state resync).  ``pipeline_ticks`` additionally returns tick
n-1's PCM while tick n is in flight (+1 block latency; ``drain()``
settles the final tick).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.dsp.stft import analysis_frames, synthesis_frames
from se_snmf_nat_tpu.io.wavio import enhanced_quantize


class MultiStreamSession:
    """Lockstep fleet of B streaming lanes over one SnmfEnhancer.

    push/flush mirror StreamingSession with a leading lane axis: push
    takes ``(B, n)`` samples (same n per lane — the lockstep clock) and
    returns the ``(B, m)`` finalized samples available so far.

    ``states``: optional per-lane engine states stacked on axis 0 (e.g.
    resuming lanes from checkpoints); defaults to B copies of the
    enhancer's initial state.

    ``mesh``: optional jax.sharding.Mesh — lanes shard over the 'data'
    axis so ONE serving session spans multiple chips (GSPMD partitions the
    same vmapped program; lanes are independent, so no collectives are
    emitted and scaling is embarrassingly parallel over the devices).
    n_streams must divide evenly over the mesh's data axis.
    """

    def __init__(self, enhancer, n_streams: int, states=None,
                 block_frames: int = 1, use_block_adaptive: bool = False,
                 mesh=None, wire: str = "frames",
                 pipeline_ticks: bool = False):
        self.enh = enhancer
        self.n = int(n_streams)
        s = enhancer.cfg.signal
        self._s = s
        self._delay = enhancer.cfg.delay
        self._queue = np.zeros((self.n, s.framelength))
        self._hold = np.zeros((self.n, 0))
        self._acc = np.zeros((self.n, s.framelength))
        # per-lane frame clock: lanes normally tick in lockstep, but a lane
        # reset mid-session (multi-tenant serving — runtime/server.py)
        # restarts ITS clock at 0 so the engine's l-dependent phases
        # (l==1 lambda_dav seed, init_N_len gating, delay emission) replay
        # for the new tenant while other lanes continue undisturbed
        self._l = np.zeros((self.n,), np.int64)
        self._block = max(int(block_frames), 1)
        self._pending: list[np.ndarray] = []   # each (B, framelength)
        # block-adaptive fleets: mid-block set_adaptation calls wait here
        # ((lanes, on) ops, applied in order at the next block boundary —
        # see set_adaptation)
        self._deferred_adapt_ops: list = []
        if states is None:
            states = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (self.n,) + a.shape),
                enhancer.initial_state())
        self._mesh = mesh
        if mesh is not None:
            from se_snmf_nat_tpu.parallel.mesh import data_sharding
            if self.n % mesh.shape["data"]:
                raise ValueError(
                    f"n_streams={self.n} must divide the mesh data axis "
                    f"({mesh.shape['data']})")
            self._shard_in = lambda a: jax.device_put(
                a, data_sharding(mesh, a.ndim, 0))
            states = jax.tree.map(self._shard_in, states)
        else:
            self._shard_in = lambda a: a
        self.state = states

        win = enhancer.win
        eng = enhancer.engine
        # match the enhancer's transform (see StreamingSession): serving
        # output keeps its solo-session/offline bit-identity when the
        # matmul DFT fast path is enabled
        dm = bool(getattr(enhancer, "dft_matmul", False))
        fp = getattr(enhancer, "dft_precision", None)
        ip = getattr(enhancer, "idft_precision", None)

        def run_one(frames, state, l0, n_valid):
            # same per-lane program as StreamingSession.run_block; the
            # lane axis is added purely by vmap below (l0 is PER-LANE so a
            # reset lane's engine clock restarts independently)
            mag, phase = analysis_frames(
                frames, win, s.fftlength, s.pow, s.dc_bin,
                s.nonzerofloor, s.preemph, dft_matmul=dm, precision=fp)
            k = frames.shape[0]
            idx = jnp.arange(k, dtype=jnp.int32)

            def step(st, xs):
                mag_t, l, i = xs
                new_st, out = eng.step(st, (mag_t, l))
                ok = i < n_valid
                st_out = jax.tree.map(lambda a, b: jnp.where(ok, a, b),
                                      new_st, st)
                return st_out, jnp.where(ok, out, jnp.zeros_like(out))

            state, xm = jax.lax.scan(step, state, (mag, l0 + idx, idx))
            out = synthesis_frames(
                xm, phase, s.framelength, s.fftlength, win, s.pow,
                s.dc_bin_back, s.overlapscale, s.preemph, dft_matmul=dm,
                precision=ip)
            return out, state

        self._run_block = jax.jit(
            jax.vmap(run_one, in_axes=(0, 0, 0, None)))

        self._run_block_fast = None
        if use_block_adaptive and self._block > 1:
            from se_snmf_nat_tpu.stream.block_adaptive import (
                make_block_step, rings_to_shift_layout)
            ba_step = make_block_step(enhancer.cfg, *enhancer._bases,
                                      enhancer.dtype, k_block=self._block,
                                      iter_cap=getattr(enhancer,
                                                       "block_iter_cap", 0))

            def run_one_fast(frames, state, ptr, l0):
                mag, phase = analysis_frames(
                    frames, win, s.fftlength, s.pow, s.dc_bin,
                    s.nonzerofloor, s.preemph, dft_matmul=dm, precision=fp)
                ls = l0 + jnp.arange(frames.shape[0], dtype=jnp.int32)
                ok = jnp.ones(frames.shape[0], bool)
                (state, ptr), xm = ba_step((state, ptr), (mag, ls, ok))
                out = synthesis_frames(
                    xm, phase, s.framelength, s.fftlength, win, s.pow,
                    s.dc_bin_back, s.overlapscale, s.preemph, dft_matmul=dm,
                    precision=ip)
                return out, state, ptr

            self._run_block_fast = jax.jit(
                jax.vmap(run_one_fast, in_axes=(0, 0, 0, 0)))
            # per-lane circular ring pointers (see StreamingSession)
            self._ba_ptr = self._shard_in(jnp.zeros((self.n,), jnp.int32))
            self._rings_to_shift = jax.jit(jax.vmap(rings_to_shift_layout))

        # ---- samples wire: the serving analog of enhance_batch's transfer
        # plan.  The frames wire ships (B, K, framelength) float frames BOTH
        # ways — 4x-redundant windows at 4 bytes/sample.  Here each tick
        # uploads the raw (B, K*shift) hop
        # samples, shifts the carried frame queue IN-GRAPH, overlap-adds
        # in-graph against a device-resident accumulator, and downloads
        # (B, K*shift) int16-scale PCM after the MATLAB int16-write rounding
        # (bit-equal to the host chain — see enhance_batch): ~16x less wire
        # traffic per tick.  Full-block ticks run on-device; partial blocks,
        # flush and lane resets fall back to the frames path with a one-shot
        # queue/acc resync (host queue mirror stays current either way).
        self._wire = wire
        if wire not in ("frames", "samples"):
            raise ValueError(f"wire must be 'frames' or 'samples': {wire}")
        self._run_block_samples = None
        self._dev_synced = False
        self._queue_preblock = None
        # the samples wire rebuilds frames as a pure shift-chain of the
        # carried queue; external queue zeroing (flush semantics,
        # zero_queue_rows) mid-block breaks that equivalence -> fall back
        self._chain_broken = False
        # cross-tick pipelining (samples wire only): push returns the
        # PREVIOUS tick's audio while the current tick is in flight —
        # the fetch round-trip hides under the next upload+compute, at
        # one block of added latency.  Values are identical, just lagged
        # (flush/drain settle the final tick); gated in tests/test_serving.
        if pipeline_ticks and wire != "samples":
            raise ValueError("pipeline_ticks requires wire='samples'")
        self._pipeline = bool(pipeline_ticks)
        self._inflight = None
        if wire == "samples":
            if use_block_adaptive:
                raise ValueError("wire='samples' runs the exact engine; "
                                 "combine with use_block_adaptive is "
                                 "unsupported")
            from se_snmf_nat_tpu.utils.matlab_compat import (
                matlab_int16_write_jax)
            shift = s.frameshift

            def run_one_samples(hops, queue, acc, state, l0):
                # hops (K, shift) -> frames via the carried queue; the
                # engine scan is run_one (identical program); OLA emits
                # one shift chunk per frame, exactly the host loop below.
                # hops may arrive as int16 (integer-valued PCM uploads at
                # 2 bytes/sample — the cast to compute dtype is exact)
                hops = hops.astype(queue.dtype)

                def fstep(q, hop):
                    q = jnp.concatenate([q[shift:], hop])
                    return q, q
                queue, frames = jax.lax.scan(fstep, queue, hops)
                out, state = run_one(frames, state, l0,
                                     jnp.asarray(hops.shape[0], jnp.int32))

                def ostep(a, fr):
                    a = a + fr
                    emit = a[:shift]
                    a = jnp.concatenate(
                        [a[shift:], jnp.zeros((shift,), a.dtype)])
                    return a, emit

                acc, emits = jax.lax.scan(ostep, acc, out)
                pcm = matlab_int16_write_jax(emits.reshape(-1))
                return pcm, queue, acc, state

            self._run_block_samples = jax.jit(
                jax.vmap(run_one_samples, in_axes=(0, 0, 0, 0, 0)))
            self._queue_dev = self._shard_in(
                jnp.zeros((self.n, s.framelength), enhancer.dtype))
            self._acc_dev = self._shard_in(
                jnp.zeros((self.n, s.framelength), enhancer.dtype))
            self._dev_synced = True

    # ------------------------------------------------------------------
    def _flush_pending(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Run queued frame ticks through one vmapped call; returns one
        ((B, frameshift) chunk, (B,) emit-mask) pair per processed tick.
        The mask is per-lane because lane clocks may differ after a
        mid-session ``reset_lanes`` (a fresh lane emits nothing until its
        own l exceeds the algorithmic delay)."""
        if not self._pending:
            return []
        s = self._s
        k = len(self._pending)
        l0 = self._l - k + 1                       # (B,) first tick's l
        if self._run_block_samples is not None and k == self._block \
                and not self._chain_broken:
            # hot path: wire = raw hop samples up, int16 PCM down.  The
            # hop of pending frame i is its trailing frameshift samples
            # (queue = concat(prev[shift:], hop)); the device rebuilds the
            # frames from its carried queue, bit-equal by construction.
            hops = np.stack([p[:, -s.frameshift:] for p in self._pending],
                            axis=1)                # (B, K, shift)
            if not self._dev_synced:
                # frames-path fallback ran since the last device tick:
                # re-seed the device queue (pre-block snapshot) and acc
                self._queue_dev = self._shard_in(
                    jnp.asarray(self._queue_preblock, self.enh.dtype))
                self._acc_dev = self._shard_in(
                    jnp.asarray(self._acc, self.enh.dtype))
                self._dev_synced = True
            # integer-valued PCM (every real int16 capture) uploads as
            # int16 — half the wire bytes; the in-graph cast is exact
            if (np.abs(hops).max(initial=0.0) <= 32767.0
                    and np.all(hops == np.rint(hops))):
                hops_up = hops.astype(np.int16)
            else:
                hops_up = np.asarray(hops, np.float32
                                     if self.enh.dtype == jnp.float32
                                     else np.float64)
            pcm, self._queue_dev, self._acc_dev, self.state = \
                self._run_block_samples(
                    self._shard_in(jnp.asarray(hops_up)),
                    self._queue_dev, self._acc_dev, self.state,
                    self._shard_in(jnp.asarray(l0, jnp.int32)))
            self._pending = []
            self._apply_deferred_adapt()
            # host acc is now stale; the device copy is authoritative
            # until a fallback pulls it (_sync_host_acc)
            if self._pipeline:
                # cross-tick pipelining: hand back the PREVIOUS tick's
                # result and leave this one in flight — the fetch of tick
                # n-1 overlaps the upload+compute of tick n, hiding the
                # round-trip at the cost of one block of added latency
                prev, self._inflight = self._inflight, (pcm, l0, k)
                if prev is None:
                    return []
                pcm, l0, k = prev
            return self._emit_pcm(np.asarray(pcm), l0, k)
        # frames-path fallback: settle any pipelined tick first (its audio
        # is older than this block's), then pull the device OLA state
        pre = self._drain_inflight()
        self._sync_host_acc()
        self._chain_broken = False                 # chain restarts below
        return pre + self._flush_pending_frames(k, l0)

    def _emit_pcm(self, pcm: np.ndarray, l0: np.ndarray, k: int
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
        s = self._s
        emitted = []
        for i in range(k):
            emitted.append(
                (pcm[:, i * s.frameshift: (i + 1) * s.frameshift]
                 .astype(np.float64), l0 + i > self._delay))
        return emitted

    def _drain_inflight(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch and emit the in-flight pipelined tick, if any."""
        if getattr(self, "_inflight", None) is None:
            return []
        pcm, l0, k = self._inflight
        self._inflight = None
        return self._emit_pcm(np.asarray(pcm), l0, k)

    def drain(self, quantize: bool = True) -> list[np.ndarray]:
        """Emit the one pipelined tick still in flight (pipeline_ticks
        sessions owe up to one block of audio between pushes)."""
        return self._assemble(self._drain_inflight(), self.n, quantize)

    def _flush_pending_frames(self, k: int, l0: np.ndarray
                              ) -> list[tuple[np.ndarray, np.ndarray]]:
        """The frames-wire tick: full (B, K, framelength) frames up, OLA on
        the host (also the fallback for partial blocks / broken chains)."""
        s = self._s
        # (B, K, framelength)
        frames = np.stack(
            self._pending + [np.zeros((self.n, s.framelength))]
            * (self._block - k), axis=1)
        frames_dev = self._shard_in(jnp.asarray(frames, self.enh.dtype))
        l0_dev = self._shard_in(jnp.asarray(l0, jnp.int32))
        if self._run_block_fast is not None and k == self._block:
            outs, self.state, self._ba_ptr = self._run_block_fast(
                frames_dev, self.state, self._ba_ptr, l0_dev)
        else:
            if self._run_block_fast is not None:
                # partial tail via the exact scan: convert rings to shift
                # layout per lane (bit-exact) and restart the pointers
                self.state = self._rings_to_shift(self.state, self._ba_ptr)
                self._ba_ptr = self._shard_in(
                    jnp.zeros((self.n,), jnp.int32))
            outs, self.state = self._run_block(
                frames_dev, self.state, l0_dev, jnp.asarray(k, jnp.int32))
        outs = np.asarray(outs)                    # (B, K, framelength)
        self._pending = []
        self._apply_deferred_adapt()
        emitted = []
        for i in range(k):
            self._acc += outs[:, i]
            emitted.append((self._acc[:, : s.frameshift].copy(),
                            l0 + i > self._delay))
            self._acc = np.concatenate(
                [self._acc[:, s.frameshift:],
                 np.zeros((self.n, s.frameshift))], axis=1)
        return emitted

    def _sync_host_acc(self) -> None:
        """Pull the OLA accumulator off the device before a frames-path
        (host-authoritative) tick; mark the device copies stale."""
        if self._run_block_samples is not None and self._dev_synced:
            self._acc = np.array(self._acc_dev, np.float64)  # writable copy
            self._dev_synced = False

    def _process_hop(self, hops: np.ndarray
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
        s = self._s
        if not self._pending and self._run_block_samples is not None:
            # snapshot the pre-block queue: if a fallback de-synced the
            # device, the next samples tick re-seeds from here
            self._queue_preblock = self._queue.copy()
        self._queue = np.concatenate(
            [self._queue[:, s.frameshift:], hops], axis=1)
        self._l += 1
        self._pending.append(self._queue.copy())
        if len(self._pending) < self._block:
            return []
        return self._flush_pending()

    @staticmethod
    def _assemble(emitted, n: int, quantize: bool) -> list[np.ndarray]:
        """Per-lane concatenation of masked emission chunks."""
        per_lane: list[list[np.ndarray]] = [[] for _ in range(n)]
        for chunk, mask in emitted:
            for i in np.nonzero(mask)[0]:
                per_lane[i].append(chunk[i])
        out = []
        for lanes in per_lane:
            y = np.concatenate(lanes) if lanes else np.zeros((0,))
            out.append(enhanced_quantize(y) if quantize else y)
        return out

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed ``(B, n)`` int16-scale samples (lockstep across lanes);
        returns the ``(B, m)`` finalized samples available so far.  Lanes
        whose clocks have diverged (after ``reset_lanes``) emit unequal
        lengths — use ``push_per_lane`` then.

        ``quantize=False`` note: on the samples wire the MATLAB int16-write
        rounding runs ON DEVICE, so device-tick chunks are post-write
        values (the pre-rounding waveform never leaves the device), while
        fallback (partial-block/flush) chunks are pre-write floats.  At
        the default ``quantize=True`` both converge bit-identically
        (the write step is idempotent on written values) — the gated
        guarantee; use the frames wire if pre-write floats matter."""
        # check BEFORE processing: raising after would lose this call's
        # emitted audio with the engine state already advanced (equal lane
        # clocks guarantee equal emission masks, hence equal lengths)
        if np.unique(self._l).size > 1:
            raise ValueError("lane clocks diverged (reset_lanes was used); "
                             "call push_per_lane for ragged emission")
        return np.stack(self.push_per_lane(samples, quantize), axis=0)

    def push_per_lane(self, samples: np.ndarray,
                      quantize: bool = True) -> list[np.ndarray]:
        """push() variant returning one 1-D array per lane (lanes may owe
        different lengths when their clocks differ)."""
        s = self._s
        samples = np.asarray(samples, np.float64)
        if samples.ndim != 2 or samples.shape[0] != self.n:
            raise ValueError(f"push expects ({self.n}, n) samples")
        buf = np.concatenate([self._hold, samples], axis=1)
        emitted = []
        while buf.shape[1] >= s.frameshift:
            hops, buf = buf[:, : s.frameshift], buf[:, s.frameshift:]
            emitted.extend(self._process_hop(hops))
        self._hold = buf
        return self._assemble(emitted, self.n, quantize)

    def flush(self, quantize: bool = True) -> np.ndarray:
        """EOF on every lane: reference flush semantics (whole queue zeroed
        per flush frame — filewise_run_IS16.m:105-113), lockstep."""
        if np.unique(self._l).size > 1:   # pre-check: see push()
            raise ValueError("lane clocks diverged; drain lanes via "
                             "zero_queue_rows + push_per_lane instead")
        s = self._s
        self._hold = np.zeros((self.n, 0))
        emitted = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros((self.n, s.framelength))
            self._queue_externally_zeroed()
            emitted.extend(self._process_hop(np.zeros((self.n,
                                                       s.frameshift))))
        emitted.extend(self._flush_pending())
        emitted.extend(self._drain_inflight())     # pipelined final tick
        return np.stack(self._assemble(emitted, self.n, quantize), axis=0)

    def set_adaptation(self, on: bool, lanes=None,
                       quantize: bool = True) -> list[np.ndarray]:
        """Per-tenant push-to-talk NAT switch (the serving form of
        StreamingSession.set_adaptation / SE_GUI.m:393-435): flips the
        traced ``adapt_on`` scalar of the selected lanes' engine states —
        no recompilation, other lanes undisturbed; effective from the next
        frame pushed.  ``lanes=None`` toggles the whole fleet.  Pending
        frames were pushed under the previous setting, so they flush under
        it first; returns their per-lane emissions (same contract as
        push_per_lane).  BLOCK-ADAPTIVE fleets defer a mid-block call to
        the next block boundary instead (no early flush — same rationale
        and boundary-equality guarantee as StreamingSession)."""
        if self._run_block_fast is not None and self._pending:
            # block-adaptive fleet mid-block: defer to the block boundary
            # (flushing a partial block early would run those frames
            # through the exact per-frame plan — a different algorithm —
            # and shift the fleet's block cadence; same rationale as
            # StreamingSession.set_adaptation)
            self._deferred_adapt_ops.append((lanes, bool(on)))
            return self._assemble([], self.n, quantize)
        emitted = self._flush_pending() if self._pending else []
        self._apply_adapt(lanes, on)
        return self._assemble(emitted, self.n, quantize)

    def _apply_adapt(self, lanes, on: bool) -> None:
        ad = np.asarray(self.state.adapt_on)
        if lanes is None:
            ad = np.full_like(ad, bool(on))
        else:
            ad = ad.copy()
            ad[np.asarray(lanes)] = bool(on)
        self.state = self.state._replace(
            adapt_on=self._shard_in(jnp.asarray(ad)))

    def _apply_deferred_adapt(self) -> None:
        for lanes, on in self._deferred_adapt_ops:
            self._apply_adapt(lanes, on)
        self._deferred_adapt_ops = []

    # ----- multi-tenant lane lifecycle (runtime/server.py) -------------
    def _queue_externally_zeroed(self) -> None:
        """Bookkeeping for the samples wire after flush-style queue zeroing:
        mid-block it breaks the shift-chain equivalence (fall back to the
        frames path for this block); between blocks the next pre-block
        snapshot captures it, but the device queue copy goes stale."""
        if self._run_block_samples is None:
            return
        if self._pending:
            self._chain_broken = True
        else:
            self._sync_host_acc()

    def zero_queue_rows(self, lanes) -> None:
        """Per-lane analog of the flush loop's queue zeroing: call before
        each drain tick of an EOF'd lane (then feed it zero hops) to
        reproduce StreamingSession.flush semantics on that lane alone."""
        self._queue[np.asarray(lanes, int)] = 0.0
        self._queue_externally_zeroed()

    def reset_lanes(self, lanes) -> None:
        """Return lanes to the enhancer's initial state for a new tenant:
        engine state, OLA accumulator, frame queue, ring pointer and the
        lane clock all restart.  Other lanes are untouched.  Must be called
        at a tick boundary with no queued partial block."""
        if self._pending:
            raise RuntimeError("reset_lanes requires an empty pending "
                               "block (tick until the block flushes)")
        if self._inflight is not None:
            # the in-flight tick belongs to the OLD tenants; emitting it
            # silently after the reset would misattribute their audio
            raise RuntimeError("reset_lanes with a pipelined tick in "
                               "flight: call drain() first")
        if self._hold.shape[1]:
            # the sample hold is fleet-wide (one column count for all
            # lanes), so a single lane's hold cannot be emptied — and
            # zero-filling it would prepend silence to the new tenant's
            # stream, breaking the solo-StreamingSession equivalence
            raise RuntimeError("reset_lanes requires an empty sample hold: "
                               "push whole hop multiples (the server does) "
                               "or drain the partial hop first")
        # samples wire: pull the live OLA accumulator before mutating the
        # host copy; the next device tick re-seeds queue+acc from host
        self._sync_host_acc()
        lanes = np.asarray(lanes, int)
        sel = np.zeros((self.n,), bool)
        sel[lanes] = True
        sel_dev = self._shard_in(jnp.asarray(sel))
        init = self.enh.initial_state()
        self.state = jax.tree.map(
            lambda full, ini: jnp.where(
                sel_dev.reshape((self.n,) + (1,) * ini.ndim),
                ini[None], full),
            self.state, init)
        if self._run_block_fast is not None:
            self._ba_ptr = jnp.where(sel_dev, 0, self._ba_ptr)
        self._queue[lanes] = 0.0
        self._acc[lanes] = 0.0
        self._l[lanes] = 0


class ShardedFleet:
    """N independent MultiStreamSession sub-fleets serving one big fleet —
    the product form of the sharded serving ceiling.

    Why sharding: on the previous accelerator one fused tick program hit
    a residency cliff past 192 lanes
    (``runtime/profiling.measure_serving_device_ceiling``), while N
    sub-fleet programs at a good lane count each kept the fast tiling.
    Whether the H100 has such a cliff is not measured.  This class ships
    that deployment shape: global lanes [i*b, (i+1)*b) live in shard i,
    every shard shares ONE compiled tick executable (identical shapes),
    and a fleet tick dispatches all shards back-to-back.

    With ``pipeline_ticks=True`` (samples wire) each shard returns tick
    n-1 while its tick n is in flight, so the PCM fetch of one shard
    overlaps the device compute of the others — the dispatch pattern the
    ceiling measurement validated, now on the product path (+1 block of
    latency, ``drain()`` settles).

    Per-lane outputs are bit-identical to one MultiStreamSession over the
    same lanes (and hence to solo StreamingSessions): lanes never interact
    and each shard runs the same program on its slice (CI-gated in
    tests/test_serving.py).  The full MultiStreamSession lane-lifecycle
    surface (reset_lanes / zero_queue_rows / set_adaptation / per-lane
    push) routes by global lane index, so runtime/server.EnhanceServer
    drops in a ShardedFleet unchanged (``cli serve --sub-fleets N``).

    Reference analog: the serving layer is SE_GUI.m:372-516's one-stream
    loop scaled out; the reference has no multi-stream story at all.
    """

    def __init__(self, enhancer, n_streams: int, sub_fleets: int,
                 block_frames: int = 1, use_block_adaptive: bool = False,
                 mesh=None, wire: str = "frames",
                 pipeline_ticks: bool = False):
        self.n = int(n_streams)
        self.n_shards = int(sub_fleets)
        if self.n_shards < 1 or self.n % self.n_shards:
            raise ValueError(
                f"n_streams={self.n} must split evenly over "
                f"sub_fleets={self.n_shards}")
        self.lanes_per_shard = self.n // self.n_shards
        self.enh = enhancer
        self.shards = [
            MultiStreamSession(enhancer, self.lanes_per_shard,
                               block_frames=block_frames,
                               use_block_adaptive=use_block_adaptive,
                               mesh=mesh, wire=wire,
                               pipeline_ticks=pipeline_ticks)
            for _ in range(self.n_shards)]
        self._block = self.shards[0]._block

    # -- lockstep bookkeeping the server reads (shards tick together, so
    #    shard 0 is representative) --------------------------------------
    @property
    def _pending(self):
        return self.shards[0]._pending

    @property
    def _l(self):
        return np.concatenate([sh._l for sh in self.shards])

    def _split(self, a: np.ndarray) -> list[np.ndarray]:
        b = self.lanes_per_shard
        return [a[i * b:(i + 1) * b] for i in range(self.n_shards)]

    def _route(self, lanes) -> list[np.ndarray]:
        """Global lane indices -> one local-index array per shard."""
        lanes = np.asarray(lanes, int)
        if lanes.size and (lanes.min() < 0 or lanes.max() >= self.n):
            raise ValueError(f"lane index out of range 0..{self.n - 1}")
        b = self.lanes_per_shard
        return [lanes[lanes // b == i] - i * b
                for i in range(self.n_shards)]

    # -- MultiStreamSession surface --------------------------------------
    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        return np.stack(self.push_per_lane(samples, quantize), axis=0)

    def push_per_lane(self, samples: np.ndarray,
                      quantize: bool = True) -> list[np.ndarray]:
        samples = np.asarray(samples, np.float64)
        if samples.ndim != 2 or samples.shape[0] != self.n:
            raise ValueError(f"push expects ({self.n}, n) samples")
        out: list[np.ndarray] = []
        # back-to-back shard dispatch: with pipeline_ticks, shard i's
        # push fetches its ALREADY-FINISHED tick n-1 and dispatches tick
        # n before shard i+1 runs — fetch overlaps the other shards'
        # device compute (the measured-ceiling dispatch pattern)
        for sh, part in zip(self.shards, self._split(samples)):
            out.extend(sh.push_per_lane(part, quantize))
        return out

    def flush(self, quantize: bool = True) -> np.ndarray:
        return np.concatenate(
            [sh.flush(quantize) for sh in self.shards], axis=0)

    def drain(self, quantize: bool = True) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        for sh in self.shards:
            out.extend(sh.drain(quantize))
        return out

    def set_adaptation(self, on: bool, lanes=None,
                       quantize: bool = True) -> list[np.ndarray]:
        routed = [None] * self.n_shards if lanes is None \
            else self._route(lanes)
        out: list[np.ndarray] = []
        # every shard flushes its pending block (even with no selected
        # lanes) so the fleet's emission clocks stay in lockstep
        for sh, loc in zip(self.shards, routed):
            out.extend(sh.set_adaptation(
                on, None if loc is None else loc, quantize))
        return out

    def zero_queue_rows(self, lanes) -> None:
        for sh, loc in zip(self.shards, self._route(lanes)):
            if len(loc):
                sh.zero_queue_rows(loc)

    def reset_lanes(self, lanes) -> None:
        for sh, loc in zip(self.shards, self._route(lanes)):
            if len(loc):
                sh.reset_lanes(loc)
