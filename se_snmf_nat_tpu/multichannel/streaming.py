"""Real-time streaming multichannel path (PMWF beamformer + online NTF).

The reference's multichannel runtime is a frame-at-a-time shell: every
frame pushes the C-channel spectra into a buffered window, accumulates the
noisy spectro-temporal covariance as a RUNNING SUM normalized in place
every ``norm_period`` frames, freezes the noise covariance from the
noise-only init period (``W`` flag, src/NTF_sep_event_RT.m:91-96), rebuilds
the per-bin PMWF filter, and emits the filtered CENTER frame of the
2L+1-frame window (src/PMWF_sep_event_RT_CHiME.m:120-203, state slots
src/init_buff_NTF.m:19-36; shipped config processes per frame —
blk_len_sep = blk_hop_sep = 1, settings/initial_setting_SNMF_NAT.m:16-17).

Re-design: the per-frame shell becomes a pure ``lax.scan`` step over
precomputed complex spectra — the SAME step drives the one-shot offline
runner, the push-based :class:`PmwfStreamingSession` (masked fixed-size
blocks, so every chunking is bit-identical to offline), and the vmapped
multi-lane batch entry (:meth:`PmwfStreamingSession.enhance_batch` /
``make_pmwf_batch_run``).  The covariance math reuses the exact
PSD_cov_mat semantics (frequency-boundary collapse) of
``multichannel.pmwf``; per-step cost is one (2M+1)(2L+1)-neighborhood
einsum + one batched (F, C, C) solve, device work with no host round
trips.

This module is the real-time form of BASELINE north-star config #4; the
offline batched form (block-mean covariances) remains
``multichannel.pmwf.PmwfEnhancer``.  The two differ semantically (running
accumulation + freeze vs per-block means) — parity here is
streaming == offline-scan-of-the-same-step, gated bit-exact in
tests/test_multichannel_streaming.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig, default_config
from se_snmf_nat_tpu.dsp.stft import overlap_add, stream_frames
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu.multichannel.pmwf import PmwfParams, pmwf_filters
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write


class PmwfStreamState(NamedTuple):
    """init_buff_NTF.m's PMWF slots as a fixed-shape scan carry."""

    y_win: jnp.ndarray   # (C, F, 2L+1) complex — TF_blk window, newest last
    ycov: jnp.ndarray    # (F, C, C) complex — running Ycov accumulator
    ncov: jnp.ndarray    # (F, C, C) complex — frozen after init_n_len
    l: jnp.ndarray       # int32 1-based frame counter (g.cnt)


def pmwf_stream_init(params: PmwfParams, n_ch: int, n_bins: int,
                     cdtype=jnp.complex64) -> PmwfStreamState:
    ml = 2 * params.l_nbr + 1
    z = jnp.zeros((n_bins, n_ch, n_ch), cdtype)
    return PmwfStreamState(y_win=jnp.zeros((n_ch, n_bins, ml), cdtype),
                           ycov=z, ncov=z, l=jnp.asarray(0, jnp.int32))


def window_cov(y_win: jnp.ndarray, m_nbr: int) -> jnp.ndarray:
    """PSD_cov_mat.m over ONE temporal window: sum of outer products over
    the (2M+1)x(2L+1) spectro-temporal neighborhood of the window center,
    with the reference's frequency-boundary collapse (bins within M of an
    edge use the uncollapsed center column).  y_win: (C, F, 2L+1) complex
    -> (F, C, C)."""
    f = y_win.shape[1]
    interior = (jnp.arange(f) >= m_nbr) & (jnp.arange(f) < f - m_nbr)
    shifts = []
    for dm in range(-m_nbr, m_nbr + 1):
        rolled = jnp.roll(y_win, -dm, axis=1)
        shifts.append(jnp.where(interior[None, :, None], rolled, y_win))
    ystack = jnp.stack(shifts, axis=0)              # (2M+1, C, F, 2L+1)
    # fp32 (HIGHEST): a bf16-rounded contraction (~1e-4 relative, measured
    # min-eig/trace -1.3e-4) makes the Hermitian sum INDEFINITE far beyond
    # any f32-scale diagonal load, and the downstream Cholesky solve blows
    # up to inf/NaN (6 coherent channels NaN from the first frame).  On the
    # H100 DEFAULT and HIGH both run TF32 (~2.5e-5 relative on an f32
    # product); chip_smoke.py's pmwf phase prints min-eig/trace at TF32 and
    # fp32.  Behind it sit the eps-relative diagonal load and the pivot
    # floor (pmwf.pmwf_filters / solve_hpd_small) as backstops.
    return jnp.einsum("mcfl,mdfl->fcd", ystack, jnp.conj(ystack),
                      precision=jax.lax.Precision.HIGHEST)


def make_pmwf_stream_step(params: PmwfParams):
    """The per-frame scan step shared by every driver.

    step(state, y_t (C, F) complex) -> (state', d (C, F) complex) where d
    is the filtered CENTER frame of the window (L frames of lookahead
    latency, exactly the reference's D(:,:,L+1) emission —
    PMWF_sep_event_RT_CHiME.m:177-203)."""
    p = params

    def step(state: PmwfStreamState, y_t: jnp.ndarray):
        y_win = jnp.concatenate([state.y_win[:, :, 1:], y_t[:, :, None]],
                                axis=2)
        l = state.l + 1
        r = window_cov(y_win, p.m_nbr)
        ycov = state.ycov + r
        # running-sum normalize IN PLACE every norm_period frames — the
        # reference's mod(g.cnt, p.norm_period)==0 quirk (:137-140), kept
        ycov = jnp.where(l % p.norm_period == 0,
                         ycov / (p.norm_period - 1), ycov)
        # W flag: noise covariance tracks Ycov through the noise-only init
        # period and freezes after (NTF_sep_event_RT.m:91-96, :143-145)
        ncov = jnp.where(l <= p.init_n_len, ycov, state.ncov)
        ecov = ycov - ncov
        h = pmwf_filters(ncov, ecov, p.beta, p.diag_load)   # (F, J, C)
        center = y_win[:, :, p.l_nbr]                        # (C, F)
        d = jnp.einsum("fjc,cf->jf", jnp.conj(h), center)
        return PmwfStreamState(y_win=y_win, ycov=ycov, ncov=ncov, l=l), d

    return step


def _analysis_one(frames, win, s, cdtype):
    """Per-channel STFT with the reference floor/DC magnitude semantics
    (identical to PmwfEnhancer's analysis, pmwf.py run())."""
    spec = jnp.fft.rfft(frames * win[None, None, :], n=s.fftlength, axis=-1)
    mag = jnp.abs(spec)
    phs = jnp.angle(spec)
    mag = mag.at[:, :, : s.dc_bin].set(0.0) + s.nonzerofloor
    return (mag * jnp.exp(1j * phs)).astype(cdtype)       # (C, T, F)


def _synthesis_one(d_seq, win, s, dtype):
    """(T, C, F) complex -> (C, n_samples) via amp/phase DC-cut iSTFT + OLA
    (same treatment as the offline enhancer)."""
    d = jnp.swapaxes(d_seq, 0, 1)                          # (C, T, F)
    amp = jnp.abs(d)
    amp = amp.at[:, :, : s.dc_bin].set(0.0)
    dspec = amp * jnp.exp(1j * jnp.angle(d))
    frames_out = jnp.fft.irfft(dspec, n=s.fftlength,
                               axis=-1)[:, :, : s.framelength]
    frames_out = frames_out.real.astype(dtype) * win[None, None, :] \
        * s.overlapscale
    return jax.vmap(lambda fr: overlap_add(fr, s.frameshift))(frames_out)


def make_pmwf_streaming_run(cfg: PipelineConfig, params: PmwfParams,
                            dtype=jnp.float32):
    """One-shot offline runner of the STREAMING semantics: jitted
    run(frames (C, T, framelength), state0) -> ((C, n) waveforms, state).
    The scan step is literally the session's step — this is the parity
    oracle the push-based session is gated against."""
    s = cfg.signal
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    win = jnp.asarray(sqrt_hann_periodic(s.framelength), dtype)
    step = make_pmwf_stream_step(params)

    @jax.jit
    def run(frames, state0):
        y = _analysis_one(frames.astype(dtype), win, s, cdtype)
        state, d_seq = jax.lax.scan(step, state0, jnp.swapaxes(y, 0, 1))
        return _synthesis_one(d_seq, win, s, dtype), state

    return run


def make_pmwf_batch_run(cfg: PipelineConfig, params: PmwfParams,
                        dtype=jnp.float32):
    """Multi-lane form: vmap of the offline streaming runner over a lane
    axis — run(frames (B, C, T, L), states (B-stacked)) -> ((B, C, n), st).
    Lane independence makes it value-identical to a per-lane loop."""
    run = make_pmwf_streaming_run(cfg, params, dtype)
    return jax.jit(jax.vmap(run, in_axes=(0, 0)))


def make_pmwf_streaming_run_fast(cfg: PipelineConfig, params: PmwfParams,
                                 dtype=jnp.float32):
    """Whole-utterance BATCHED plan of the streaming semantics (r5).

    Budget analysis of the scan plan on the previous accelerator: most of
    its wall time was scan serialization, not math — the per-frame step
    does ~6 MFLOP of covariance/solve/apply work but pays a sequential
    step latency far above that work's compute time, and adding lanes only
    deepened the per-step working set (throughput fell as lanes grew).

    The only frame-to-frame dependence in the semantics is the running
    Ycov sum with its periodic in-place normalize
    (PMWF_sep_event_RT_CHiME.m:137-140) — the window covariance (25-term
    neighborhood einsum), the per-bin HPD filter solves, the filter apply
    and the iSTFT have none.  So this plan:

      1. computes ALL frame-window covariances R_t in one vmapped
         ``window_cov`` (same function, batched over T);
      2. runs the Ycov recurrence as a scan over just ``ycov += R_t``
         plus the norm_period divide — an (F, C, C) add per step, the
         irreducible sequential core;
      3. freezes Ncov by INDEXING the Ycov trajectory at init_n_len
         (NTF_sep_event_RT.m:91-96) instead of carrying it;
      4. batches the per-bin solves/filters over all T frames at once
         (``pmwf_filters`` vmapped — 1.4M independent unrolled Cholesky
         solves per 8-lane utterance, pure fused elementwise ops);
      5. applies filters and synthesizes batched.

    Semantics identical to ``make_pmwf_streaming_run`` (same component
    functions, adds in the same order); outputs are gated equal after the
    int16 write at x64 and f32 in tests/test_multichannel_streaming.py.
    The scan plan stays the default/parity path; sessions use it.
    """
    s = cfg.signal
    p = params
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    win = jnp.asarray(sqrt_hann_periodic(s.framelength), dtype)
    ml = 2 * p.l_nbr + 1

    @jax.jit
    def run(frames, state0):
        y = _analysis_one(frames.astype(dtype), win, s, cdtype)  # (C,T,F)
        t = y.shape[1]
        # sliding windows continuing from the carried y_win: window t
        # holds frames [t-2L .. t] (state tail before the first input)
        tail = jnp.moveaxis(state0.y_win, 2, 1)[:, 1:, :]  # (C, ml-1, F)
        ypad = jnp.concatenate([tail, y], axis=1)          # (C, T+ml-1, F)
        # R_t decomposes over the window's frames: window_cov sums outer
        # products over the (2M+1) x (2L+1) neighborhood, so with
        # G_tau = sum_m outer(z^m_tau) (the per-frame frequency-collapsed
        # covariance), R_t = sum_{tau in window t} G_tau.  Computing G
        # once per frame and box-summing is 2L+1 times fewer multiplies
        # than per-window einsums AND avoids materializing the
        # (T, 2M+1, C, F, 2L+1) stack a vmapped window_cov would build
        # (29 GB at 8 lanes — the r5 budget run's first OOM).  Regrouping
        # the 25-term sum into 5x5 changes only summation ORDER; the x64
        # gate vs the scan plan is post-int16-write (tests).
        #
        # LAYOUT: every whole-trajectory covariance tensor keeps (C, C)
        # LEADING and (T/F) trailing — the previous accelerator's (8, 128)
        # tiles padded a trailing (6, 6) pair 28x (an OOM); (..., 6, 513)
        # pads only 1.3x.  Not re-examined on the H100.
        f = ypad.shape[2]
        nc = ypad.shape[0]
        interior = (jnp.arange(f) >= p.m_nbr) & (jnp.arange(f)
                                                 < f - p.m_nbr)
        shifts = []
        for dm in range(-p.m_nbr, p.m_nbr + 1):
            rolled = jnp.roll(ypad, -dm, axis=2)
            shifts.append(jnp.where(interior[None, None, :], rolled, ypad))
        # per-(i, j) covariance trajectories as a flat PAIRS axis
        # (T', C*C, F) built from elementwise multiply-adds: an einsum's
        # (..., C, C, ...) dot output got a tile layout whose tiny C dims
        # padded 28x on the previous accelerator (an OOM), while the
        # pair-stacked layout pads ~1.4x.
        # Summation over the 2M+1 shifts stays in index order (parity).
        pairs = []
        for i in range(nc):
            for j in range(nc):
                acc_ij = shifts[0][i] * jnp.conj(shifts[0][j])
                for m in range(1, 2 * p.m_nbr + 1):
                    acc_ij = acc_ij + shifts[m][i] * jnp.conj(shifts[m][j])
                pairs.append(acc_ij)               # (T', F)
        g = jnp.stack(pairs, axis=1)               # (T', P, F)
        r_all = g[:t]
        for i in range(1, ml):
            r_all = r_all + g[i: i + t]            # (T, P, F)

        ls = state0.l + 1 + jnp.arange(t, dtype=jnp.int32)
        divs = (ls % p.norm_period) == 0

        def acc(ycov, inp):
            r_t, div = inp
            ycov = ycov + r_t
            ycov = jnp.where(div, ycov / (p.norm_period - 1), ycov)
            return ycov, ycov

        ycov0 = jnp.transpose(state0.ycov, (1, 2, 0)).reshape(nc * nc, f)
        ycov_last, ycovs = jax.lax.scan(acc, ycov0, (r_all, divs))
        # frozen Ncov: the Ycov value at l == init_n_len — inside this
        # call if the stream crosses the boundary here, else the carried
        # state (already-frozen streams)
        idx = p.init_n_len - state0.l - 1
        frozen = jnp.where(
            idx >= 0,
            jax.lax.dynamic_index_in_dim(
                ycovs, jnp.clip(idx, 0, t - 1), axis=0, keepdims=False),
            jnp.transpose(state0.ncov, (1, 2, 0)).reshape(nc * nc, f))
        in_init = (ls <= p.init_n_len)[:, None]           # (T, 1)
        h = _pmwf_filters_leading(ycovs, frozen, in_init, nc, p)
        centers = ypad[:, p.l_nbr: p.l_nbr + t, :]        # (C, T, F)
        d_seq = jnp.einsum("jctf,ctf->tjf", jnp.conj(h), centers)
        ncov_last = jnp.where(state0.l + t <= p.init_n_len, ycov_last,
                              frozen)
        state = PmwfStreamState(
            y_win=jnp.moveaxis(ypad[:, t - 1: t - 1 + ml, :], 1, 2),
            ycov=jnp.transpose(ycov_last.reshape(nc, nc, f), (2, 0, 1)),
            ncov=jnp.transpose(ncov_last.reshape(nc, nc, f), (2, 0, 1)),
            l=state0.l + t)
        return _synthesis_one(d_seq, win, s, dtype), state

    return run


def _pmwf_filters_leading(ycovs: jnp.ndarray, frozen: jnp.ndarray,
                          in_init: jnp.ndarray, c: int, p: PmwfParams,
                          flr: float = 1e-9) -> jnp.ndarray:
    """``pmwf.pmwf_filters`` + ``solve_hpd_small`` on the fast plan's
    flat-PAIRS covariance layout: ycovs (T, C*C, F), frozen (C*C, F),
    in_init (T, 1) bool -> filter bank (J, C, T, F).

    Same math in the same per-element order as the trailing-layout
    originals (eps-relative diagonal load, unrolled Cholesky with
    eps-relative pivot floors, forward/backward substitution, trace
    normalize) — layout is the only difference, because (8, 128) tile
    padding made a whole-trajectory (T, F, 6, 6) tensor 28x its logical
    size on the previous accelerator.  Ncov/Ecov are formed per (i, j) entry from the
    Ycov trajectory + frozen value, so neither is ever materialized as a
    full tensor.  x64 parity with the scan plan is gated post-int16-write
    in tests/test_multichannel_streaming.py."""
    rdtype = jnp.real(ycovs).dtype
    eps = jnp.finfo(ycovs.dtype).eps
    tiny = jnp.finfo(ycovs.dtype).tiny

    def ncov(i, j):                                 # (T, F)
        return jnp.where(in_init, ycovs[:, i * c + j],
                         frozen[None, i * c + j])

    def ecov(i, j):
        return ycovs[:, i * c + j] - ncov(i, j)

    # a = Ncov + (diag_load + eps*trace/C) I   (pmwf_filters:172-176)
    tr_n = sum(jnp.real(ncov(i, i)) for i in range(c))
    load = (p.diag_load + eps * tr_n / c).astype(rdtype)

    def a(i, j):
        base = ncov(i, j)
        return base + load if i == j else base

    # unrolled Cholesky with eps-relative pivot floors (solve_hpd_small)
    l = [[None] * c for _ in range(c)]
    for i in range(c):
        pivot_flr = eps * jnp.real(a(i, i)) + tiny
        for j in range(i + 1):
            sij = a(i, j)
            for k in range(j):
                sij = sij - l[i][k] * jnp.conj(l[j][k])
            if i == j:
                l[i][j] = jnp.sqrt(
                    jnp.maximum(jnp.real(sij), pivot_flr)).astype(
                    ycovs.dtype)
            else:
                l[i][j] = sij / l[j][j]
    # columns of Ecov solved per k: necov[:, k] = A^-1 Ecov[:, k]
    necov = [[None] * c for _ in range(c)]
    for k in range(c):
        y = [None] * c
        for i in range(c):
            sik = ecov(i, k)
            for m in range(i):
                sik = sik - l[i][m] * y[m]
            y[i] = sik / l[i][i]
        x = [None] * c
        for i in reversed(range(c)):
            sik = y[i]
            for m in range(i + 1, c):
                sik = sik - jnp.conj(l[m][i]) * x[m]
            x[i] = sik / l[i][i]
        for i in range(c):
            necov[i][k] = x[i]
    lam = necov[0][0]
    for i in range(1, c):
        lam = lam + necov[i][i]
    scale = p.beta + lam + flr
    # H[j, c'] = necov[c', j] / scale   (pmwf_filters:177-180)
    return jnp.stack([
        jnp.stack([necov[cp][j] / scale for cp in range(c)])
        for j in range(c)])


def make_pmwf_batch_run_fast(cfg: PipelineConfig, params: PmwfParams,
                             dtype=jnp.float32):
    """vmap of the batched streaming-semantics plan over a lane axis —
    the deployment shape of the MULTICHANNEL bench rows."""
    run = make_pmwf_streaming_run_fast(cfg, params, dtype)
    return jax.jit(jax.vmap(run, in_axes=(0, 0)))


class PmwfStreamingSession:
    """Push-based real-time multichannel PMWF enhancement.

    push(samples (C, n)) consumes int16-scale multichannel audio in any
    chunking and returns finalized (C, m) enhanced samples; outputs are
    bit-identical to the one-shot offline runner on the same stream
    (masked fixed-size blocks, the StreamingSession recipe).  Latency =
    the engine delay + the beamformer's L-frame lookahead (the emitted
    frame is the window center).
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: PmwfParams | None = None, n_ch: int = 6,
                 block_frames: int = 8, dtype=jnp.float32):
        self.cfg = cfg or default_config()
        self.params = params or PmwfParams()
        self.dtype = dtype
        s = self.cfg.signal
        self._s = s
        self._delay = self.cfg.delay
        self.n_ch = n_ch
        self._block = max(int(block_frames), 1)
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        self._cdtype = cdtype
        win = jnp.asarray(sqrt_hann_periodic(s.framelength), dtype)
        step = make_pmwf_stream_step(self.params)
        self.state = pmwf_stream_init(self.params, n_ch, s.n_bins, cdtype)
        self._queue = np.zeros((n_ch, s.framelength))
        self._hold = np.zeros((n_ch, 0))
        self._acc = np.zeros((n_ch, s.framelength))
        self._l = 0
        self._pending: list[np.ndarray] = []

        @jax.jit
        def run_block(frames, state, n_valid):
            # frames: (K, C, framelength); padding frames run masked so a
            # partial tail block reuses the executable and leaves state
            # bit-identical to never having seen the padding
            y = _analysis_one(jnp.swapaxes(frames, 0, 1).astype(dtype),
                              win, s, cdtype)              # (C, K, F)
            idx = jnp.arange(frames.shape[0], dtype=jnp.int32)

            def mstep(st, xs):
                y_t, i = xs
                new_st, d = step(st, y_t)
                ok = i < n_valid
                st_out = jax.tree.map(lambda a, b: jnp.where(ok, a, b),
                                      new_st, st)
                return st_out, jnp.where(ok, d, jnp.zeros_like(d))

            state, d_seq = jax.lax.scan(mstep, state,
                                        (jnp.swapaxes(y, 0, 1), idx))
            # per-frame synthesis (no OLA here; the host accumulates)
            amp = jnp.abs(d_seq)
            amp = amp.at[:, :, : s.dc_bin].set(0.0)
            dspec = amp * jnp.exp(1j * jnp.angle(d_seq))
            fr = jnp.fft.irfft(dspec, n=s.fftlength,
                               axis=-1)[:, :, : s.framelength]
            fr = fr.real.astype(dtype) * win[None, None, :] * s.overlapscale
            return fr, state                               # (K, C, L)

        self._run_block = run_block

    def reset(self, state=None) -> None:
        s = self._s
        self._queue = np.zeros((self.n_ch, s.framelength))
        self._hold = np.zeros((self.n_ch, 0))
        self._acc = np.zeros((self.n_ch, s.framelength))
        self._l = 0
        self._pending = []
        self.state = state if state is not None else pmwf_stream_init(
            self.params, self.n_ch, s.n_bins, self._cdtype)

    def _flush_pending(self) -> list[np.ndarray]:
        if not self._pending:
            return []
        s = self._s
        k = len(self._pending)
        frames = np.stack(
            self._pending + [np.zeros((self.n_ch, s.framelength))]
            * (self._block - k))
        outs, self.state = self._run_block(
            jnp.asarray(frames, self.dtype), self.state,
            jnp.asarray(k, jnp.int32))
        outs = np.asarray(outs)
        self._pending = []
        l0 = self._l - k + 1
        emitted = []
        for i in range(k):
            self._acc += outs[i]
            if l0 + i > self._delay:
                emitted.append(self._acc[:, : s.frameshift].copy())
            self._acc = np.concatenate(
                [self._acc[:, s.frameshift:],
                 np.zeros((self.n_ch, s.frameshift))], axis=1)
        return emitted

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """samples: (C, n) int16-scale; returns (C, m) finalized output."""
        s = self._s
        samples = np.atleast_2d(np.asarray(samples, np.float64))
        buf = np.concatenate([self._hold, samples], axis=1)
        outs = []
        while buf.shape[1] >= s.frameshift:
            hop, buf = buf[:, : s.frameshift], buf[:, s.frameshift:]
            self._queue = np.concatenate(
                [self._queue[:, s.frameshift:], hop], axis=1)
            self._l += 1
            self._pending.append(self._queue.copy())
            if len(self._pending) >= self._block:
                outs.extend(self._flush_pending())
        self._hold = buf
        y = (np.concatenate(outs, axis=1) if outs
             else np.zeros((self.n_ch, 0)))
        return matlab_int16_write(y) if quantize else y

    def flush(self, quantize: bool = True) -> np.ndarray:
        """EOF: drain delay+1 zero-queue flush frames plus the partial
        block (same contract as the single-channel session)."""
        s = self._s
        self._hold = np.zeros((self.n_ch, 0))
        outs = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros((self.n_ch, s.framelength))
            self._l += 1
            self._pending.append(self._queue.copy())
            if len(self._pending) >= self._block:
                outs.extend(self._flush_pending())
        outs.extend(self._flush_pending())
        y = (np.concatenate(outs, axis=1) if outs
             else np.zeros((self.n_ch, 0)))
        return matlab_int16_write(y) if quantize else y


def pmwf_streaming_enhance(x: np.ndarray, cfg: PipelineConfig | None = None,
                           params: PmwfParams | None = None,
                           dtype=jnp.float32, quantize: bool = True,
                           state: PmwfStreamState | None = None,
                           return_state: bool = False,
                           fast: bool = False):
    """Offline convenience wrapper of the STREAMING semantics on one
    (C, n) utterance — frames exactly like PmwfEnhancer.enhance and trims
    the same delay.  ``fast=True`` selects the whole-utterance batched
    plan (``make_pmwf_streaming_run_fast`` — ~7x on-device at identical
    x64 post-write output; see the budget notes there)."""
    cfg = cfg or default_config()
    params = params or PmwfParams()
    s = cfg.signal
    x = np.atleast_2d(np.asarray(x, np.float64))
    frames = np.stack([
        stream_frames(ch, s.framelength, s.frameshift,
                      n_flush=cfg.delay + 1) for ch in x])
    run = (make_pmwf_streaming_run_fast if fast
           else make_pmwf_streaming_run)(cfg, params, dtype)
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    st0 = state if state is not None else pmwf_stream_init(
        params, x.shape[0], s.n_bins, cdtype)
    y, st = run(jnp.asarray(frames, dtype), st0)
    start = cfg.delay * s.frameshift
    emit = np.asarray(y)[:, start: start
                         + (frames.shape[1] - cfg.delay) * s.frameshift]
    if params.ref_ch is not None:
        emit = emit[params.ref_ch: params.ref_ch + 1]
    out = matlab_int16_write(emit) if quantize else emit
    return (out, st) if return_state else out


# ---------------------------------------------------------------------------
# Online NTF channel-loading tracking (GIST_NTF.m:88-129 C-step, streaming)
# ---------------------------------------------------------------------------

class NtfOnlineState(NamedTuple):
    c: jnp.ndarray       # (C, K) channel loadings, carried across blocks
    l: jnp.ndarray       # int32 blocks consumed


def make_ntf_online_step(b: jnp.ndarray, *, sparsity: float = 5.0,
                         inner_iters: int = 4, flr: float = 1e-9):
    """Per-block online C-step: a fixed number of KL multiplicative
    channel-loading updates on the incoming block tensor, warm-started
    from the carried loadings — the streaming form of GIST_NTF_C.m's
    C_UPDATE branch (A fixed at ones, the shipped config).  The spectral
    basis ``b`` (N, K) is fixed and L2-normalized once here, exactly as
    the batch solver does at entry (GIST_NTF_C.m:27-30).

    step(state, s_blk (C, N, M)) -> (state', c) — c is the post-update
    loading snapshot for the block."""
    bn = jnp.sqrt(jnp.sum(b * b, axis=0))
    b = b / jnp.where(bn > 0, bn, 1.0)
    sum_b = jnp.sum(b, axis=0)

    def step(state: NtfOnlineState, s_blk: jnp.ndarray):
        dtype = s_blk.dtype
        m = s_blk.shape[2]
        a = jnp.ones((m, b.shape[1]), dtype)
        oba = jnp.maximum((sum_b * jnp.sum(a, axis=0))[None, :], flr)
        c = state.c.astype(dtype)

        def one(c, _):
            xh = jnp.maximum(jnp.einsum("ck,nk,mk->cnm", c, b, a), flr)
            pt = jnp.maximum(s_blk / xh, flr)
            pba = jnp.maximum(jnp.einsum("cnm,nk,mk->ck", pt, b, a), flr)
            return jnp.maximum(c * pba / (oba + sparsity), flr), None

        c, _ = jax.lax.scan(one, c, None, length=inner_iters)
        return NtfOnlineState(c=c, l=state.l + 1), c

    return step


class NtfStreamingSession:
    """Block-push online NTF channel-loading tracker.

    push_block(s_blk (C, N, M)) runs ``inner_iters`` warm-started C-updates
    and returns the updated (C, K) loadings.  On a stationary stream the
    carried loadings converge to the batch ``ntf_solve`` solution
    (tests/test_multichannel_streaming.py gates cosine agreement)."""

    def __init__(self, b: np.ndarray, n_ch: int, *, sparsity: float = 5.0,
                 inner_iters: int = 4, c0: np.ndarray | None = None,
                 dtype=jnp.float32):
        from se_snmf_nat_tpu.multichannel.ntf import default_c_init
        b = jnp.asarray(b, dtype)
        bn = np.sqrt(np.sum(np.asarray(b) ** 2, axis=0))
        c_init = (jnp.asarray(c0, dtype) if c0 is not None
                  else jnp.asarray(default_c_init(n_ch, b.shape[1]), dtype)
                  * jnp.asarray(bn, dtype)[None, :])
        self.state = NtfOnlineState(c=c_init, l=jnp.asarray(0, jnp.int32))
        self._step_fn = make_ntf_online_step(
            b, sparsity=sparsity, inner_iters=inner_iters)
        self._step = jax.jit(self._step_fn)

    @property
    def loadings(self) -> np.ndarray:
        return np.asarray(self.state.c)

    def push_block(self, s_blk: np.ndarray) -> np.ndarray:
        self.state, c = self._step(self.state, jnp.asarray(
            s_blk, self.state.c.dtype))
        return np.asarray(c)

    def push_blocks(self, s_blks: np.ndarray) -> np.ndarray:
        """Consume MANY blocks in one device call: a ``lax.scan`` of the
        same step over the leading block axis — bit-identical to calling
        ``push_block`` per block (gated), at one dispatch for the whole
        sequence.  Why it exists: the per-block C-step is ~0.1 GFLOP, so
        a per-block device call is mostly dispatch overhead.

        s_blks: (B, C, N, M).  Returns the (B, C, K) loading snapshots.
        """
        if not hasattr(self, "_scan_steps"):
            self._scan_steps = jax.jit(
                lambda st, blks: jax.lax.scan(self._step_fn, st, blks))
        self.state, cs = self._scan_steps(
            self.state, jnp.asarray(s_blks, self.state.c.dtype))
        return np.asarray(cs)
