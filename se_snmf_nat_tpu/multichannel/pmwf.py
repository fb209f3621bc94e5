"""Parameterized Multichannel Wiener Filter with spectro-temporal
covariances — offline beamformer in JAX.

Reference math: src/PSD_cov_mat.m (Jin/Shin/Kim SPL 2015 spectro-temporal
covariance) + src/PMWF_sep_event_RT_CHiME.m:120-177 (noise covariance frozen
from the init period, Ecov = Ycov - Ncov, per-bin filter
H_j = (Ncov+eps I)^-1 Ecov / (beta + trace) u_j).  The reference's streaming
shell is dead code (SURVEY §2.2); this re-design keeps its covariance and
filter math exactly and replaces the frame-at-a-time accumulation with a
batched plan:

  device: per-channel batched STFT -> complex spectra Y (C, F, T)
          -> neighborhood covariances via shifted einsum stacks
          -> Ncov = mean over the init period; per-block Ycov means
          -> batched (F,C,C) solves + trace -> filters per block
          -> filtered spectra -> batched iSTFT + OLA per output channel

Boundary semantics of PSD_cov_mat.m:13-17 are kept: frequency bins within
M_PMWF of either edge collapse the whole frequency neighborhood onto the
center bin.  Parameters all come from the shipped settings
(initial_setting_SNMF_NAT.m:78-85).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig, default_config
from se_snmf_nat_tpu.dsp.stft import overlap_add, stream_frames
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write


@dataclass(frozen=True)
class PmwfParams:
    """initial_setting_SNMF_NAT.m:78-85 (+ init_N_len :57)."""

    beta: float = 10.0           # p.BETA_PMWF (0: MVDR-like, >0: PMWF)
    m_nbr: int = 2               # p.M_PMWF spectral neighbor radius
    l_nbr: int = 2               # p.L_PMWF temporal neighbor radius
    init_n_len: int = 15         # noise-only init frames
    norm_period: int = 15        # p.norm_period block size for Ycov means
    diag_load: float = 1e-3      # eps*I on Ncov before the solve (:148)
    ref_ch: int | None = None    # None: output all channels; else one


def spectro_temporal_cov(y: jnp.ndarray, m_nbr: int, l_nbr: int
                         ) -> jnp.ndarray:
    """Per-frame spectro-temporal covariances.

    y: (C, F, T) complex spectra.  Returns (T, F, C, C) where entry t is
    sum over the (2*m_nbr+1)x(2*l_nbr+1) neighborhood of frame t
    (PSD_cov_mat.m with the boundary-collapse rule; time edges clamp to the
    valid range, matching the reference's behavior of only evaluating
    frames with a full temporal neighborhood).
    """
    c, f, t = y.shape
    # frequency neighborhood stack with boundary collapse
    shifts = []
    interior = (jnp.arange(f) >= m_nbr) & (jnp.arange(f) < f - m_nbr)
    for dm in range(-m_nbr, m_nbr + 1):
        rolled = jnp.roll(y, -dm, axis=1)
        shifts.append(jnp.where(interior[None, :, None], rolled, y))
    ystack = jnp.stack(shifts, axis=0)             # (2M+1, C, F, T)
    # per-frame frequency-neighborhood outer products in fp32 (HIGHEST):
    # reduced-precision products leave this Hermitian sum INDEFINITE (see
    # streaming.window_cov), which the downstream diagonally-loaded
    # Cholesky cannot survive.  On the H100 DEFAULT and HIGH both run TF32
    # (~2.5e-5 relative on an f32 product, chip_smoke.py device phase)
    r = jnp.einsum("mcft,mdft->tfcd", ystack, jnp.conj(ystack),
                   precision=jax.lax.Precision.HIGHEST)
    # temporal box sum of width 2L+1 with edge clamping
    if l_nbr > 0:
        pad = jnp.pad(r, ((l_nbr, l_nbr), (0, 0), (0, 0), (0, 0)),
                      mode="edge")
        cs = jnp.cumsum(pad, axis=0)
        zero = jnp.zeros_like(cs[:1])
        cs = jnp.concatenate([zero, cs], axis=0)
        r = cs[2 * l_nbr + 1:] - cs[: t]
    return r


def solve_hpd_small(a: jnp.ndarray, b: jnp.ndarray,
                    max_unrolled: int = 8) -> jnp.ndarray:
    """Batched A^-1 B for small Hermitian-positive-definite A — unrolled
    Cholesky + triangular substitutions in pure elementwise jnp ops.

    a: (..., C, C) HPD (the diagonally loaded noise covariance — PSD outer
    product sums + eps*I, so no pivoting is needed); b: (..., C, K).

    Why not jnp.linalg.solve: XLA lowers it to an LU custom call that is
    catastrophic for tiny batched systems inside a scan — 93% of the
    streaming-PMWF frame step on the previous accelerator — and the
    complex LU path is additionally unimplemented on some backends.  The unrolled form is ~C^3 vectorized
    elementwise ops over the batch, which XLA fuses into the surrounding
    step.  C larger than max_unrolled falls back to jnp.linalg.solve
    (unroll size grows cubically)."""
    c = a.shape[-1]
    if c > max_unrolled:
        return jnp.linalg.solve(a, b)
    # Cholesky a = L L^H, unrolled (diagonal is real positive for HPD).
    # Pivot floor: coherent multichannel input (e.g. copies of one signal
    # with sample offsets — also real mic arrays at low frequencies) makes
    # the covariance rank-1 with entries >> diag_load, so the absolute
    # eps*I the reference adds (PMWF_sep_event_RT_CHiME.m:148) is below
    # the working dtype's rounding and the Schur complement can round
    # NEGATIVE -> sqrt -> NaN poisons the whole filter bank.  Clamping
    # each pivot to an eps-relative floor of its own diagonal entry is
    # bit-exact (max(x, smaller)=x) whenever the solve is well-conditioned
    # and acts as rounding-level regularization exactly where f64 MATLAB's
    # inv() was only surviving by rounding luck.
    eps = jnp.finfo(a.dtype).eps     # real-typed for complex dtypes
    tiny = jnp.finfo(a.dtype).tiny
    l = [[None] * c for _ in range(c)]
    for i in range(c):
        flr = eps * jnp.real(a[..., i, i]) + tiny
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * jnp.conj(l[j][k])
            if i == j:
                l[i][j] = jnp.sqrt(
                    jnp.maximum(jnp.real(s), flr)).astype(a.dtype)
            else:
                l[i][j] = s / l[j][j]
    # forward substitution L y = b  (columns of b solved together)
    y = [None] * c
    for i in range(c):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[i][k][..., None] * y[k]
        y[i] = s / l[i][i][..., None]
    # backward substitution L^H x = y
    x = [None] * c
    for i in reversed(range(c)):
        s = y[i]
        for k in range(i + 1, c):
            s = s - jnp.conj(l[k][i])[..., None] * x[k]
        x[i] = s / l[i][i][..., None]
    return jnp.stack(x, axis=-2)


def pmwf_filters(ncov: jnp.ndarray, ecov: jnp.ndarray, beta: float,
                 diag_load: float, flr: float = 1e-9) -> jnp.ndarray:
    """(F, C, C) covariances -> (F, C, C) filter bank H with
    H[f, j, :] = column j of (Ncov+eps I)^-1 Ecov scaled by
    1/(beta + trace + flr)  (PMWF_sep_event_RT_CHiME.m:148-165).

    The per-bin solve runs as the unrolled HPD Cholesky
    (``solve_hpd_small``) — (Ncov + diag_load*I) is PSD + eps*I by
    construction.

    Loading is the reference's ABSOLUTE diag_load plus an eps-RELATIVE
    term at the working precision (eps * trace/C per bin).  Rationale:
    coherent channels (copies of one signal with sample offsets; real mic
    arrays at low frequencies) make Ncov rank-1 with entries many orders
    above diag_load, so the absolute load alone is below the dtype's
    rounding — the solve's condition number then exceeds 1/eps and in
    complex64 the result overflows f32 (inf), after which the
    1/(beta+trace) normalize turns it into NaN and poisons the whole
    output (measured: 6 coherent channels NaN from the first emitted
    frame).  The relative term bounds the condition number at ~C/eps
    while perturbing well-conditioned solves only at rounding level —
    in float64 it adds ~2e-16*trace, below the reference f64 inv()'s own
    rounding, so reference semantics are preserved where they are
    numerically meaningful at all."""
    f, c, _ = ncov.shape
    eye = jnp.eye(c, dtype=ncov.dtype)
    tr_n = jnp.real(jnp.trace(ncov, axis1=1, axis2=2))[:, None, None]
    load = diag_load + jnp.finfo(ncov.dtype).eps * tr_n / c
    necov = solve_hpd_small(ncov + load * eye[None], ecov)
    lam = jnp.trace(necov, axis1=1, axis2=2)[:, None, None]
    scaled = necov / (beta + lam + flr)
    # H[j,:,f] = scaled[:, j] -> arrange as (F, out_ch j, in_ch c)
    return jnp.swapaxes(scaled, 1, 2)


class PmwfEnhancer:
    """Offline multichannel PMWF enhancement."""

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: PmwfParams | None = None, dtype=jnp.float32):
        self.cfg = cfg or default_config()
        self.params = params or PmwfParams()
        self.dtype = dtype
        s = self.cfg.signal
        p = self.params
        win = jnp.asarray(sqrt_hann_periodic(s.framelength), dtype)
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

        @jax.jit
        def run(frames):                    # frames: (C, T, framelength)
            ch, t, _ = frames.shape
            spec = jnp.fft.rfft(frames.astype(dtype) * win[None, None, :],
                                n=s.fftlength, axis=-1)
            mag = jnp.abs(spec)
            phs = jnp.angle(spec)
            # reference floor/DC semantics on magnitude (engine :66-78)
            mag = mag.at[:, :, : s.dc_bin].set(0.0) + s.nonzerofloor
            y = (mag * jnp.exp(1j * phs)).astype(cdtype)   # (C, T, F)
            y = jnp.swapaxes(y, 1, 2)                      # (C, F, T)

            covs = spectro_temporal_cov(y, p.m_nbr, p.l_nbr)  # (T,F,C,C)
            n_init = min(p.init_n_len, t)
            # the reference normalizes accumulated covariances by
            # (norm_period - 1) — sum/(n-1), not a mean — and the scale
            # does NOT cancel through (Ncov+dI)^-1 Ecov/(beta+tr) because
            # diag_load and beta are absolute (PMWF_sep_event_RT_CHiME.m:
            # 117,138)
            ncov = jnp.sum(covs[:n_init], axis=0) / max(n_init - 1, 1)
            # per-block accumulated noisy covariance (norm_period frames)
            n_blocks = -(-t // p.norm_period)
            pad_t = n_blocks * p.norm_period - t
            covs_p = jnp.concatenate(
                [covs, jnp.repeat(covs[-1:], pad_t, axis=0)], axis=0) \
                if pad_t else covs
            ycov_blocks = covs_p.reshape(
                n_blocks, p.norm_period, *covs.shape[1:]).sum(axis=1) \
                / (p.norm_period - 1)
            ecov_blocks = ycov_blocks - ncov[None]
            h = jax.vmap(lambda e: pmwf_filters(
                ncov, e, p.beta, p.diag_load))(ecov_blocks)  # (B,F,J,C)

            block_idx = jnp.minimum(jnp.arange(t) // p.norm_period,
                                    n_blocks - 1)
            h_t = h[block_idx]                              # (T, F, J, C)
            d = jnp.einsum("tfjc,cft->jft", jnp.conj(h_t), y)

            # iSTFT + OLA per output channel
            amp = jnp.abs(d)
            amp = amp.at[:, : s.dc_bin, :].set(0.0)
            dspec = jnp.swapaxes(amp * jnp.exp(1j * jnp.angle(d)), 1, 2)
            frames_out = jnp.fft.irfft(dspec, n=s.fftlength,
                                       axis=-1)[:, :, : s.framelength]
            frames_out = frames_out.real.astype(dtype) * win[None, None, :] \
                * s.overlapscale
            return jax.vmap(lambda fr: overlap_add(fr, s.frameshift))(
                frames_out)

        self._run = run

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        """x: (C, N) int16-scale multichannel samples -> (C or 1, N_out)."""
        s = self.cfg.signal
        x = np.atleast_2d(np.asarray(x, np.float64))
        frames = np.stack([
            stream_frames(ch, s.framelength, s.frameshift,
                          n_flush=self.cfg.delay + 1) for ch in x])
        y = np.asarray(self._run(jnp.asarray(frames, self.dtype)))
        start = self.cfg.delay * s.frameshift
        emit = y[:, start: start
                 + (frames.shape[1] - self.cfg.delay) * s.frameshift]
        if self.params.ref_ch is not None:
            emit = emit[self.params.ref_ch: self.params.ref_ch + 1]
        return matlab_int16_write(emit) if quantize else emit
