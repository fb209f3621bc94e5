"""Offline / batched enhancement pipelines.

Replaces the reference's streaming runners (filewise_run_IS16.m,
src/NTF_sep_event_RT.m) with a batched device execution plan:

  host:   int16 wav -> zero-prepadded frame matrix      (io/, dsp/)
  device: batched STFT -> lax.scan(frame engine) -> batched iSTFT -> OLA
  host:   delay trim -> MATLAB-exact int16 quantization

Utterances batch with vmap over (state, frames); right-padding with zero
frames is safe because the scan is causal — outputs for real frames never
see padding, and per-utterance emitted lengths are sliced on the host.

Cross-utterance noise-dictionary persistence (the reference's B_D_u.mat
load/save, NTF_sep_event_RT.m:28-38,136-139) is the ``carry_state`` option:
the final EngineState of one utterance seeds the next.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig, default_config
from se_snmf_nat_tpu.dsp.stft import (
    analysis_frames, overlap_add, pack_samples_for_upload, stream_frames,
    stream_frames_jax, synthesis_frames)
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu.enhance.engine import make_engine
from se_snmf_nat_tpu.io.wavio import enhanced_quantize
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write_jax


class SnmfEnhancer:
    """Builds jitted single-utterance and batched enhancement functions."""

    def __init__(self, cfg: PipelineConfig | None, b1_x, b1_d, b2_x, b2_d,
                 dtype=jnp.float32, matlab_ad_blk_init: bool = True,
                 frame_bucket: int = 128, block_adapt: int = 0,
                 block_iter_cap: int = 0, warm_start: bool = False,
                 dft_matmul: bool = False, block_refit_cap: int = 0,
                 block_fixed_iter: bool = False,
                 block_split_solve: bool = False,
                 block_refit_fixed: bool = False,
                 dft_precision: str | None = None,
                 idft_precision: str | None = None):
        self.cfg = cfg or default_config()
        s = self.cfg.signal
        self.dtype = dtype
        if warm_start and block_adapt:
            raise ValueError("warm_start applies to the exact scan plan; "
                             "combine with block_adapt is unsupported")
        self.warm_start = warm_start
        # opt-in matmul transform: STFT/iSTFT as matmuls
        # (dsp/stft.dft_matrices); default off so the x64 oracle bit-parity
        # gates stay pinned to jnp.fft
        self.dft_matmul = bool(dft_matmul)
        # per-direction matmul-transform precision overrides (None = the
        # dsp/stft module defaults, 'highest' both ways).  The headline
        # plan runs analysis 'high' / synthesis 'default' — see
        # stream/block_adaptive.make_block_adaptive_run for the measured
        # asymmetry rationale.  Only meaningful with dft_matmul=True.
        self.dft_precision = dft_precision
        self.idft_precision = idft_precision
        self.engine = make_engine(self.cfg, b1_x, b1_d, b2_x, b2_d, dtype,
                                  warm_start=warm_start)
        self.win = jnp.asarray(sqrt_hann_periodic(s.framelength), dtype)
        self._state0 = self.engine.init_state(dtype, matlab_ad_blk_init)
        self._bases = (b1_x, b1_d, b2_x, b2_d)
        self._run_sources = None     # built lazily by separate()
        # utterance lengths round up to frame_bucket frames so every length
        # in a bucket shares one compiled executable (padding frames run
        # masked); without this, sequential campaigns recompile per length
        self.frame_bucket = max(int(frame_bucket), 1)

        # non-adaptive fast plan: the per-frame H-solves leave the scan and
        # become one batched solve (stream/fast_pipeline.py)
        from se_snmf_nat_tpu.stream.fast_pipeline import (
            make_fast_run, supports_fast_plan)
        self._fast_run = (make_fast_run(self.cfg, b1_x, b1_d, b2_x, b2_d,
                                        dtype, dft_matmul=self.dft_matmul,
                                        dft_precision=dft_precision,
                                        idft_precision=idft_precision)
                          if supports_fast_plan(self.cfg) and not warm_start
                          else None)
        self._fast_run_batch = (
            jax.jit(jax.vmap(self._fast_run, in_axes=(0, None)))
            if self._fast_run is not None else None)

        # opt-in block-adaptive plan (documented approximation — see
        # stream/block_adaptive.py); frame_bucket must be a multiple of the
        # block so bucketed padding stays block-aligned
        self._block_run = None
        self.block_iter_cap = block_iter_cap if block_adapt > 0 else 0
        if block_adapt > 0:
            from se_snmf_nat_tpu.stream.block_adaptive import (
                make_block_adaptive_run)
            if self.frame_bucket % block_adapt:
                # bucket only sets compile sharing (padding frames are
                # inert), so round up to block alignment rather than error
                self.frame_bucket = (-(-self.frame_bucket // block_adapt)
                                     * block_adapt)
            self._block_run = make_block_adaptive_run(
                self.cfg, b1_x, b1_d, b2_x, b2_d, dtype, block_adapt,
                block_iter_cap, dft_matmul=self.dft_matmul,
                refit_iter_cap=block_refit_cap,
                fixed_iter=block_fixed_iter,
                split_solve=block_split_solve,
                refit_fixed=block_refit_fixed,
                dft_precision=dft_precision,
                idft_precision=idft_precision)
            self._block_run_batch = jax.jit(
                jax.vmap(self._block_run, in_axes=(0, 0, None, 0)))

        def masked_step(t_valid):
            def step(state, xs):
                _, l = xs
                new_state, out = self.engine.step(state, xs)
                valid = l <= t_valid
                state_out = jax.tree.map(
                    lambda a, b: jnp.where(valid, a, b), new_state, state)
                return state_out, jnp.where(valid, out, jnp.zeros_like(out))
            return step

        @jax.jit
        def run(frames, state0, t_valid):
            mag, phase = analysis_frames(
                frames, self.win, s.fftlength, s.pow, s.dc_bin,
                s.nonzerofloor, s.preemph, dft_matmul=self.dft_matmul,
                precision=self.dft_precision)
            t = mag.shape[0]
            ls = jnp.arange(1, t + 1, dtype=jnp.int32)
            state, xm_tilde = jax.lax.scan(masked_step(t_valid), state0,
                                           (mag, ls))
            out_frames = synthesis_frames(
                xm_tilde, phase, s.framelength, s.fftlength, self.win, s.pow,
                s.dc_bin_back, s.overlapscale, s.preemph,
                dft_matmul=self.dft_matmul, precision=self.idft_precision)
            y = overlap_add(out_frames, s.frameshift)
            return y, state

        self._run_masked = run
        self._run = lambda frames, state0: run(
            frames, state0, jnp.asarray(frames.shape[0], jnp.int32))
        self._run_batch_masked = jax.jit(jax.vmap(run, in_axes=(0, 0, 0)))
        self._run_batch = lambda frames, states: self._run_batch_masked(
            frames, states,
            jnp.full((frames.shape[0],), frames.shape[1], jnp.int32))

        # samples-in / int16-out batched entry points: raw samples upload,
        # in-graph framing (stream_frames_jax), and the MATLAB fwrite-int16
        # rounding (round half-away, saturate — matlab_compat.
        # matlab_int16_write) applied ON DEVICE.  Neither the 4x-redundant
        # frame matrix nor float waveforms cross host<->device.  x+0.5 and
        # floor are exact over the int16 range
        # in f32, so the device rounding is bit-equal to the host chain.
        _to_pcm = matlab_int16_write_jax

        # Integer-valued inputs (every wav read — MATLAB fread-int16 scale)
        # additionally upload as int16 and cast to the compute dtype
        # in-graph (exact): 2x less upload than f32, 4x less than f64.
        def scan_from_samples(smp, nh, state, tv):
            y, st = run(stream_frames_jax(smp.astype(self.dtype), nh,
                                          s.framelength, s.frameshift),
                        state, tv)
            return _to_pcm(y), st

        self._run_batch_samples = jax.jit(
            jax.vmap(scan_from_samples, in_axes=(0, 0, 0, 0)))
        self._fast_run_batch_samples = None
        if self._fast_run is not None:
            def fast_from_samples(smp, nh, win_arr):
                return _to_pcm(self._fast_run(
                    stream_frames_jax(smp.astype(self.dtype), nh,
                                      s.framelength, s.frameshift),
                    win_arr))
            self._fast_run_batch_samples = jax.jit(
                jax.vmap(fast_from_samples, in_axes=(0, 0, None)))
        self._block_run_batch_samples = None
        if self._block_run is not None:
            def block_from_samples(smp, nh, state, win_arr, tv):
                y, st = self._block_run(
                    stream_frames_jax(smp.astype(self.dtype), nh,
                                      s.framelength, s.frameshift),
                    state, win_arr, tv)
                return _to_pcm(y), st
            self._block_run_batch_samples = jax.jit(
                jax.vmap(block_from_samples, in_axes=(0, 0, 0, None, 0)))

    def _pad_frames(self, frames: np.ndarray) -> np.ndarray:
        t = frames.shape[0]
        t_pad = -(-t // self.frame_bucket) * self.frame_bucket
        if t_pad == t:
            return frames
        return np.concatenate(
            [frames, np.zeros((t_pad - t,) + frames.shape[1:])], axis=0)

    # ------------------------------------------------------------------
    def frames_for(self, x: np.ndarray) -> np.ndarray:
        s = self.cfg.signal
        return stream_frames(x, s.framelength, s.frameshift,
                             n_flush=self.cfg.delay + 1)

    def initial_state(self):
        return self._state0

    def enhance(self, x: np.ndarray, state=None, return_state: bool = False,
                quantize: bool = True):
        """Enhance one utterance of int16-scale samples."""
        s = self.cfg.signal
        true_frames = self.frames_for(x)
        t = true_frames.shape[0]
        frames = jnp.asarray(self._pad_frames(true_frames), self.dtype)
        if self._block_run is not None:
            y, state_out = self._block_run(
                frames, state if state is not None else self._state0,
                self.win, jnp.asarray(t, jnp.int32))
            start = self.cfg.delay * s.frameshift
            emit = np.asarray(
                y[start: start + (t - self.cfg.delay) * s.frameshift])
            out = enhanced_quantize(emit) if quantize else emit
            return (out, state_out) if return_state else out
        if self._fast_run is not None and state is None and not return_state:
            # per-column solver independence makes padded columns inert,
            # so the bucketed fast plan is bit-equal to the unpadded one
            y = self._fast_run(frames, self.win)
            start = self.cfg.delay * s.frameshift
            emit = np.asarray(
                y[start: start + (t - self.cfg.delay) * s.frameshift])
            return enhanced_quantize(emit) if quantize else emit
        y, state_out = self._run_masked(
            frames, state if state is not None else self._state0,
            jnp.asarray(t, jnp.int32))
        start = self.cfg.delay * s.frameshift
        emit = np.asarray(y[start: start + (t - self.cfg.delay) * s.frameshift])
        out = enhanced_quantize(emit) if quantize else emit
        return (out, state_out) if return_state else out

    def separate(self, x: np.ndarray, state=None, quantize: bool = True):
        """Source separation: per-event and per-noise waveforms alongside
        the enhanced signal (the reference engine's x_hat / d_hat outputs,
        bnmf_sep_event_RT_IS16.m:349-363 — each source's NMF reconstruction
        synthesized with the noisy phase).  Returns a dict with keys
        'enhanced', 'events' (E,), 'noises' (N,)."""
        s = self.cfg.signal
        if self._run_sources is None:
            eng = make_engine(self.cfg, *self._bases, self.dtype,
                              emit_sources=True)

            @jax.jit
            def run_sources(frames, state0, t_valid):
                # frames are bucket-padded (frame_bucket) with a masked
                # scan so mixed-length files share one executable —
                # previously every distinct length recompiled the plan
                mag, phase = analysis_frames(
                    frames, self.win, s.fftlength, s.pow, s.dc_bin,
                    s.nonzerofloor, s.preemph, dft_matmul=self.dft_matmul,
                    precision=self.dft_precision)
                t = mag.shape[0]
                ls = jnp.arange(1, t + 1, dtype=jnp.int32)
                idx = jnp.arange(t, dtype=jnp.int32)

                def step(st, xs):
                    mag_t, l, i = xs
                    new_st, out = eng.step(st, (mag_t, l))
                    ok = i < t_valid
                    st_out = jax.tree.map(
                        lambda a, b: jnp.where(ok, a, b), new_st, st)
                    out = jax.tree.map(
                        lambda o: jnp.where(ok, o, jnp.zeros_like(o)), out)
                    return st_out, out

                _, (xm, xs_srcs, ds_srcs) = jax.lax.scan(
                    step, state0, (mag, ls, idx))

                def synth(m):
                    fr = synthesis_frames(
                        m, phase, s.framelength, s.fftlength, self.win,
                        s.pow, s.dc_bin_back, s.overlapscale, s.preemph,
                        dft_matmul=self.dft_matmul,
                        precision=self.idft_precision)
                    return overlap_add(fr, s.frameshift)

                y = synth(xm)
                y_ev = jax.vmap(synth, in_axes=1)(xs_srcs)
                y_no = jax.vmap(synth, in_axes=1)(ds_srcs)
                return y, y_ev, y_no

            self._run_sources = run_sources

        true_frames = self.frames_for(x)
        t = true_frames.shape[0]
        frames = jnp.asarray(self._pad_frames(true_frames), self.dtype)
        y, y_ev, y_no = self._run_sources(
            frames, state if state is not None else self._state0,
            jnp.asarray(t, jnp.int32))
        start = self.cfg.delay * s.frameshift
        stop = start + (t - self.cfg.delay) * s.frameshift

        def emit(a):
            a = np.asarray(a[..., start:stop])
            return enhanced_quantize(a) if quantize else a

        return {"enhanced": emit(y),
                "events": [emit(y_ev[i]) for i in range(y_ev.shape[0])],
                "noises": [emit(y_no[i]) for i in range(y_no.shape[0])]}

    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Enhance a batch of utterances (padded to the longest bucket).

        Uploads RAW SAMPLES (frames in-graph, stream_frames_jax) and
        fetches int16 PCM (MATLAB int16-write rounding in-graph): neither
        the 4x-redundant frame matrix nor float waveforms cross
        host<->device.  Outputs are value-identical to the per-utterance
        path (test_engine test_batch_matches_single gates x64
        bit-equality); with ``quantize=False`` the returned floats are the
        post-int16-write values (the pre-rounding waveform never leaves
        the device).

        ``micro_batch``: split the batch into fixed-size chunks and
        DISPATCH THEM ALL before fetching any result — JAX's async
        dispatch then overlaps chunk n+1's upload and compute with chunk
        n's download (double buffering, which pays when host<->device
        transfers dominate).  Lane independence under vmap makes
        the outputs value-identical to the single-call path (chunk lane
        padding is inert); gated by
        test_engine.py::test_batch_micro_batch_identical.  None = one
        call."""
        s = self.cfg.signal
        shift = s.frameshift
        n_flush = self.cfg.delay + 1
        n_hops_all = np.asarray([len(x) // shift for x in xs], np.int32)
        t_true_all = n_hops_all + n_flush       # == frames_for(x).shape[0]
        # ONE bucketed width for every chunk so all chunks share one
        # compiled executable
        t_max = -(-int(t_true_all.max()) // self.frame_bucket) \
            * self.frame_bucket
        np_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))

        states = None
        if (self._block_run_batch_samples is not None
                or self._fast_run_batch_samples is None):
            states = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (mb,) + a.shape), self._state0)

        def dispatch(chunk, n_hops, t_true):
            # lane-pad the tail chunk to mb so every chunk reuses the one
            # compiled program (padded lanes run on zeros and are dropped)
            n = len(chunk)
            smp = np.zeros((mb, t_max * shift), np.float64)
            for i, x in enumerate(chunk):
                m = int(n_hops[i]) * shift      # trailing partial hop drops
                smp[i, :m] = np.asarray(x)[:m]
            nh = np.zeros((mb,), np.int32)
            nh[:n] = n_hops
            tt = np.full((mb,), n_flush, np.int32)
            tt[:n] = t_true
            smp_dev = jnp.asarray(pack_samples_for_upload(smp, np_dt))
            nh_dev = jnp.asarray(nh)
            if self._block_run_batch_samples is not None:
                ys, _ = self._block_run_batch_samples(
                    smp_dev, nh_dev, states, self.win, jnp.asarray(tt))
            elif self._fast_run_batch_samples is not None:
                ys = self._fast_run_batch_samples(smp_dev, nh_dev, self.win)
            else:
                ys, _ = self._run_batch_samples(
                    smp_dev, nh_dev, states, jnp.asarray(tt))
            return ys                            # device array: NOT fetched

        pending = []                             # all dispatched up front
        for c0 in range(0, len(xs), mb):
            pending.append(dispatch(xs[c0: c0 + mb],
                                    n_hops_all[c0: c0 + mb],
                                    t_true_all[c0: c0 + mb]))

        from se_snmf_nat_tpu.utils.matlab_compat import (
            matlab_wavwrite_quantize)
        outs = []
        start = self.cfg.delay * shift
        for ci, ys_dev in enumerate(pending):
            ys = np.asarray(ys_dev)              # blocks on THIS chunk only
            for i in range(min(mb, len(xs) - ci * mb)):
                g = ci * mb + i
                emit = ys[i, start: start
                          + (int(t_true_all[g]) - self.cfg.delay) * shift]
                # device did the int16-write stage; finish the pcm2wav
                # requantize (wavio.enhanced_quantize's second step) on host
                outs.append(matlab_wavwrite_quantize(
                    emit.astype(np.float64) / 32767.0) if quantize
                    else emit.astype(np.float64))
        return outs
