"""Hop-by-hop real-time streaming session.

The reference's live paths consume 160-sample hops: the filewise runner's
frame queue (filewise_run_IS16.m:102-169) and the GUI mic loop
(SE_GUI.m:372-516).  StreamingSession is that loop as an API: push one hop,
get back the finalized 160 enhanced samples (after the 3-hop algorithmic
delay), with the engine state carried across pushes — the SAME jitted
engine step as the offline scan, so streaming output is bit-identical to
the offline pipeline (tested).

The per-frame device program is one scan step + one rfft/irfft pair.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.dsp.stft import analysis_frames, synthesis_frames
from se_snmf_nat_tpu.io.wavio import enhanced_quantize


class StreamingSession:
    """Wraps a SnmfEnhancer for one-hop-at-a-time processing.

    block_frames > 1 trades latency for per-hop cost: hops accumulate until
    `block_frames` are pending, then one jitted scan processes the block
    (each device call carries a fixed dispatch overhead, so a block of K
    amortizes it K-fold; outputs are still bit-identical to
    block_frames=1 because the scan runs the same steps in the same order).
    """

    def __init__(self, enhancer, state=None, block_frames: int = 1,
                 use_block_adaptive: bool = False):
        self.enh = enhancer
        s = enhancer.cfg.signal
        self._s = s
        self._delay = enhancer.cfg.delay
        self._queue = np.zeros(s.framelength)
        self._hold = np.zeros(0)            # partial-hop residue
        self._acc = np.zeros(s.framelength)  # OLA accumulator
        self._l = 0
        self._block = max(int(block_frames), 1)
        self._pending: list[np.ndarray] = []   # queued analysis frames
        # block sessions: a mid-block set_adaptation waits here until the
        # pending block completes (see set_adaptation)
        self._deferred_adapt: bool | None = None
        self.state = state if state is not None else enhancer.initial_state()

        win = enhancer.win
        eng = enhancer.engine
        # propagate the enhancer's transform choice so streaming output
        # stays bit-identical to the offline plan when the matmul DFT
        # fast path is enabled (dsp/stft.dft_matrices)
        dm = bool(getattr(enhancer, "dft_matmul", False))
        fp = getattr(enhancer, "dft_precision", None)
        ip = getattr(enhancer, "idft_precision", None)

        @jax.jit
        def run_block(frames, state, l0, n_valid):
            # fixed block size; trailing padding frames run masked so a
            # partial tail block reuses the same executable
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

            state, xm = jax.lax.scan(step, state,
                                     (mag, l0 + idx, idx))
            out = synthesis_frames(
                xm, phase, s.framelength, s.fftlength, win, s.pow,
                s.dc_bin_back, s.overlapscale, s.preemph, dft_matmul=dm,
                precision=ip)
            return out, state

        self._run_block = run_block

        # optional: solve FULL blocks through the block-adaptive plan
        # (batched K-frame solves, one refit per block — the documented
        # approximation of stream/block_adaptive.py); the partial tail
        # block at flush still goes through the exact masked scan above
        self._run_block_fast = None
        if use_block_adaptive and self._block > 1:
            from se_snmf_nat_tpu.stream.block_adaptive import (
                make_block_step, ring_ptr0, rings_to_shift_layout)
            ba_step = make_block_step(enhancer.cfg, *enhancer._bases,
                                      enhancer.dtype, k_block=self._block,
                                      iter_cap=getattr(enhancer,
                                                       "block_iter_cap", 0))

            @jax.jit
            def run_block_fast(frames, state, ptr, l0):
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

            self._run_block_fast = run_block_fast
            # circular write position of the block step's adaptation rings,
            # carried across pushes exactly like the offline plan's scan
            # carry; reset whenever the state converts to shift layout
            self._ba_ptr = ring_ptr0()
            self._rings_to_shift = jax.jit(rings_to_shift_layout)

    def set_adaptation(self, on: bool, quantize: bool = True) -> np.ndarray:
        """Live noise-adaptation switch — SE_GUI.m:393-435's push-to-talk
        NAT toggle.  Flips the traced ``adapt_on`` scalar carried in
        EngineState, so no recompilation; while off, frames are treated as
        supervised: triggers cannot fire and the rings / update counter /
        dictionary head stay untouched (tests/test_streaming.py gates
        this).

        Granularity: exact-scan sessions flush the pending frames under
        the previous setting (they were pushed under it) and apply the
        toggle from the next frame.  BLOCK-ADAPTIVE sessions defer a
        mid-block toggle to the next block boundary instead — flushing a
        partial block early would route those frames through the exact
        per-frame plan (a different algorithm than the block plan) and
        permanently shift the session's block cadence; deferral keeps the
        stream bit-identical to one toggled exactly at the boundary
        (tests/test_streaming.py gates that equality).  Any samples
        finalized by the flush are returned (same contract as push)."""
        if self._run_block_fast is not None and self._pending:
            self._deferred_adapt = bool(on)
            y = np.zeros(0)
            return enhanced_quantize(y) if quantize else y
        outs = self._flush_pending() if self._pending else []
        self.state = self.state._replace(adapt_on=jnp.asarray(bool(on)))
        y = np.concatenate(outs) if outs else np.zeros(0)
        return enhanced_quantize(y) if quantize else y

    def reset(self, state=None) -> None:
        """Return the session to t=0 for a new stream REUSING this
        instance's compiled programs (the jitted closures are
        per-instance, so constructing a new session re-traces and
        re-compiles): engine state, frame queue, OLA
        accumulator, hold, pending block and the l clock all restart.
        A warmed-then-reset session is bit-identical to a fresh one."""
        s = self._s
        self._queue = np.zeros(s.framelength)
        self._hold = np.zeros(0)
        self._acc = np.zeros(s.framelength)
        self._l = 0
        self._pending = []
        self.state = state if state is not None else \
            self.enh.initial_state()
        self._deferred_adapt = None
        if self._run_block_fast is not None:
            from se_snmf_nat_tpu.stream.block_adaptive import ring_ptr0
            self._ba_ptr = ring_ptr0()

    def _flush_pending(self) -> list[np.ndarray]:
        """Run the queued frames through one jitted scan; returns emitted
        hop chunks."""
        if not self._pending:
            return []
        s = self._s
        k = len(self._pending)
        frames = np.stack(self._pending
                          + [np.zeros(s.framelength)] * (self._block - k))
        l0 = self._l - k + 1
        if self._run_block_fast is not None and k == self._block:
            outs, self.state, self._ba_ptr = self._run_block_fast(
                jnp.asarray(frames, self.enh.dtype), self.state,
                self._ba_ptr, jnp.asarray(l0, jnp.int32))
        else:
            if self._run_block_fast is not None:
                # partial tail runs through the exact scan: hand it the
                # shift-layout rings (bit-exact conversion) and restart the
                # circular pointer at 0 over the rotated contents
                from se_snmf_nat_tpu.stream.block_adaptive import ring_ptr0
                self.state = self._rings_to_shift(self.state, self._ba_ptr)
                self._ba_ptr = ring_ptr0()
            outs, self.state = self._run_block(
                jnp.asarray(frames, self.enh.dtype), self.state,
                jnp.asarray(l0, jnp.int32), jnp.asarray(k, jnp.int32))
        outs = np.asarray(outs)
        self._pending = []
        if self._deferred_adapt is not None:
            # block-boundary application of a mid-block set_adaptation
            # (see its docstring) — the flushed frames above ran under
            # the previous setting, as pushed
            self.state = self.state._replace(
                adapt_on=jnp.asarray(self._deferred_adapt))
            self._deferred_adapt = None
        emitted = []
        for i in range(k):
            self._acc += outs[i]
            if l0 + i > self._delay:
                emitted.append(self._acc[: s.frameshift].copy())
            self._acc = np.concatenate(
                [self._acc[s.frameshift:], np.zeros(s.frameshift)])
        return emitted

    def _process_hop(self, hop: np.ndarray) -> np.ndarray | None:
        s = self._s
        self._queue = np.concatenate([self._queue[s.frameshift:], hop])
        self._l += 1
        self._pending.append(self._queue.copy())
        if len(self._pending) < self._block:
            return None
        out = self._flush_pending()
        return np.concatenate(out) if out else None

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed any number of int16-scale samples; returns the finalized
        output samples available so far (possibly empty)."""
        s = self._s
        buf = np.concatenate([self._hold,
                              np.asarray(samples, np.float64).reshape(-1)])
        outs = []
        while len(buf) >= s.frameshift:
            hop, buf = buf[: s.frameshift], buf[s.frameshift:]
            e = self._process_hop(hop)
            if e is not None:
                outs.append(e)
        self._hold = buf
        y = np.concatenate(outs) if outs else np.zeros(0)
        return enhanced_quantize(y) if quantize else y

    def flush(self, quantize: bool = True) -> np.ndarray:
        """EOF: drop the partial hop and process delay+1 flush frames with
        the queue FULLY ZEROED (the reference zeroes the whole queue at
        EOF instead of shifting hops in — filewise_run_IS16.m:105-113)."""
        s = self._s
        self._hold = np.zeros(0)
        outs = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros(s.framelength)   # whole queue, not a shift
            e = self._process_hop(np.zeros(s.frameshift))
            if e is not None:
                outs.append(e)
        tail = self._flush_pending()                # drain a partial block
        outs.extend(tail)
        y = np.concatenate(outs) if outs else np.zeros(0)
        return enhanced_quantize(y) if quantize else y
