"""Batched STFT / iSTFT for the enhancement pipeline.

Batched design: the reference computes one 1024-point FFT per 10 ms hop
inside a MATLAB while-loop (bnmf_sep_event_RT_IS16.m:66-78,
synth_ifft_buff.m:12-33).  Here all frames of an utterance are transformed in
one batched ``jnp.fft.rfft``/``irfft`` over a (T, fftlen) array so XLA maps
the whole spectrogram onto the chip in one shot; streaming callers can still
pass T=1.

Semantics reproduced from the reference (DFT mode, the live path):
  * per-frame FIR pre-emphasis y[k] = x[k] - a*x[k-1] with y[0] = x[0]
    (state NOT carried across frames — filter() restarted per frame);
  * sqrt-periodic-Hann window, zero-pad framelength -> fftlength;
  * magnitude ``|Y|**pow`` over bins 0..fftlen/2, phase kept separately;
  * the lowest ``dc_bin`` bins zeroed, then ``nonzerofloor`` added
    (engine :75-78 — note the floor is added to every processed column);
  * synthesis: mag**(1/pow) with dc_bin_back rows zeroed, conjugate-symmetric
    spectrum from (mag, phase), real(ifft)[:framelength], synthesis window,
    de-emphasis IIR, scaled by overlapscale; overlap-add with hop.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def stream_frames(x: np.ndarray, framelength: int, frameshift: int,
                  n_flush: int) -> np.ndarray:
    """Frames exactly as the reference's streaming queue produces them.

    The runner shifts ``frameshift`` new samples into the tail of a
    zero-initialized ``framelength`` queue each hop (filewise_run_IS16.m:
    120-122), processes ``floor(len(x)/frameshift)`` data hops (the trailing
    partial hop is dropped), then processes ``n_flush`` all-zero frames at
    EOF (:105-113 — note the queue is fully zeroed, not shifted, during
    flush).  Equivalent closed form: frame l (0-based) of the signal
    zero-prepended by (framelength - frameshift) samples.

    Returns (T, framelength) float64 with T = floor(len/shift) + n_flush.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n_hops = len(x) // frameshift
    pad = framelength - frameshift
    xp = np.concatenate([np.zeros(pad), x[: n_hops * frameshift]])
    idx = np.arange(framelength)[None, :] + \
        frameshift * np.arange(n_hops)[:, None]
    frames = xp[idx]
    if n_flush:
        frames = np.concatenate(
            [frames, np.zeros((n_flush, framelength))], axis=0)
    return frames


def stream_frames_jax(samples: jnp.ndarray, n_hops: jnp.ndarray,
                      framelength: int, frameshift: int) -> jnp.ndarray:
    """``stream_frames`` computed ON DEVICE (inside jit) from raw samples.

    The (T, framelength) frame matrix carries every sample
    framelength/frameshift (= 4x) times, so uploading samples and framing
    in-graph cuts the transfer ~4x (9x vs a float64 host frame matrix).
    The gather is the closed form of the reference's streaming queue and
    is value-identical to ``stream_frames`` (gated in test_dsp):

    ``samples``: (S,) with S = T * frameshift for the bucketed frame
    count T; entries beyond ``n_hops * frameshift`` MUST be zero (host
    zero-pads; the trailing partial hop is dropped there too).
    ``n_hops``: traced scalar — frames at l >= n_hops are zeroed, exactly
    like the reference's flush frames (the queue is zeroed, not shifted,
    at EOF: filewise_run_IS16.m:105-113) and the bucket's padding frames.
    """
    t_bucket = samples.shape[-1] // frameshift
    pad = framelength - frameshift
    xp = jnp.pad(samples, (pad, framelength))
    idx = (jnp.arange(framelength)[None, :]
           + frameshift * jnp.arange(t_bucket)[:, None])
    frames = xp[idx]
    mask = jnp.arange(t_bucket)[:, None] < n_hops
    return frames * mask.astype(frames.dtype)


def pack_samples_for_upload(smp: np.ndarray, np_dtype=np.float32) -> np.ndarray:
    """Pick the narrowest exact wire dtype for a sample upload.

    Every wav read yields integer-valued doubles in int16 scale (MATLAB
    fread-int16 semantics, io/wavio.py), so the batch entry points can ship
    int16 to the device — 2x less than f32, 4x less than f64 — and cast to
    the compute dtype in-graph (int16 -> f32/f64 is exact, so outputs are
    bit-identical).  Non-integer or out-of-range inputs (synthetic floats)
    fall back to ``np_dtype``.

    Compile-stability note: the wire dtype is a jit signature axis — a
    batch entry sees ONE compilation per wire dtype it encounters.  Wav-fed
    campaigns are always integer-valued (one executable); only mixing
    synthetic float inputs into the same enhancer adds the one-time float
    compilation.
    """
    if (smp.size
            and np.all(smp == np.floor(smp))
            and smp.min() >= -32768 and smp.max() <= 32767):
        return smp.astype(np.int16)
    return np.asarray(smp, np_dtype)


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def preemphasis(frames: jnp.ndarray, coeff: float) -> jnp.ndarray:
    """Per-frame FIR pre-emphasis (reference restarts filter state each
    frame: bnmf_sep_event_RT_IS16.m:67, stft_fft.m:22)."""
    if coeff == 0.0:
        return frames
    shifted = jnp.pad(frames[..., :-1], [(0, 0)] * (frames.ndim - 1) + [(1, 0)])
    return frames - coeff * shifted


_DFT_MATRIX_CACHE: dict = {}


# Matmul-DFT precision.  'highest' (full f32 products) is the module
# default and the transform's own accuracy anchor.  On the H100 'high' and
# 'default' both run f32 matmuls in TF32 (chip_smoke.py device phase).
DFT_PRECISION = "highest"

# Synthesis (inverse) transform precision.  None = follow DFT_PRECISION.
# Rationale for the split: analysis-DFT rounding perturbs the magnitudes
# the NMF solves consume, so its error is AMPLIFIED through the solver
# trajectory, while synthesis rounding adds only LINEAR noise to the
# output (headline.py picks its pair per direction).
IDFT_PRECISION = None


def _idft_precision():
    return DFT_PRECISION if IDFT_PRECISION is None else IDFT_PRECISION


def dft_matrices(framelength: int, fftlength: int, dtype=np.float32):
    """Real DFT as two (framelength, F) matmul operands, and the inverse
    (F, framelength) pair.

    The 1024-point transform of 640 nonzero samples as two matmuls.  It
    was written for an accelerator whose FFT was slow; on one H100 SXM
    (700 W) cuFFT is faster: 37,634 frames take 0.56 ms to analyse and
    0.85 ms to synthesise through ``jnp.fft``, 1.01 ms and 1.05 ms through
    the stacked matmuls at the headline's 'high'/'default' precisions
    (chip_smoke.py timings phase).  Forward:
    ``re = y @ C, im = y @ S``.  Inverse (conjugate-symmetric, truncated to
    framelength as synth_ifft_buff.m:16-24 does): ``y = re @ Ci + im @ Si``.

    Multi-chip: the matmul transform also PARTITIONS — under a 'data' mesh
    GSPMD shards it over the lane axis like any contraction, whereas the
    FFT op cannot shard over batch dims and costs an all-gather of the
    full (B, T, fft) batch per call (tests/test_collectives.py gates both
    behaviors).
    """
    key = (framelength, fftlength, np.dtype(dtype).name)
    hit = _DFT_MATRIX_CACHE.get(key)
    if hit is not None:
        return hit
    f = fftlength // 2 + 1
    k = np.arange(fftlength)[:framelength, None] * np.arange(f)[None, :] \
        * (2.0 * np.pi / fftlength)
    c = np.cos(k)
    s = -np.sin(k)
    # inverse: y_n = (1/N) sum_k w_k (re_k cos - im_k sin), w = 2 except the
    # DC and Nyquist bins (conjugate-symmetric real ifft)
    wk = np.full((f, 1), 2.0)
    wk[0] = 1.0
    if fftlength % 2 == 0:
        wk[-1] = 1.0
    n = np.arange(framelength)[None, :]
    ki = np.arange(f)[:, None] * n * (2.0 * np.pi / fftlength)
    ci = wk * np.cos(ki) / fftlength
    si = -wk * np.sin(ki) / fftlength
    # cache as NumPy: jnp arrays created inside a jit trace would leak
    # tracers across calls; as np constants they fold into each jaxpr
    out = tuple(np.asarray(a, dtype) for a in (c, s, ci, si))
    _DFT_MATRIX_CACHE[key] = out
    return out


def dft_matrices_stacked(framelength: int, fftlength: int, dtype=np.float32):
    """The dft_matrices operands stacked for ONE matmul per direction:
    forward (framelength, 2F) = [C | S] so ``y @ CS = [re | im]``, inverse
    (2F, framelength) = [Ci ; Si] so ``[re | im] @ CiSi = y``.

    One product replaces two at identical FLOPs, and the wider N = 2F
    tiles better than F=513.  Each output element is the same dot product
    as in the two-matmul form.
    """
    key = ("stacked", framelength, fftlength, np.dtype(dtype).name)
    hit = _DFT_MATRIX_CACHE.get(key)
    if hit is not None:
        return hit
    c, s, ci, si = dft_matrices(framelength, fftlength, dtype)
    out = (np.concatenate([c, s], axis=1),
           np.concatenate([ci, si], axis=0))
    _DFT_MATRIX_CACHE[key] = out
    return out


def analysis_frames(frames: jnp.ndarray, win: jnp.ndarray, fftlength: int,
                    pow_: float, dc_bin: int, nonzerofloor: float,
                    preemph: float = 0.0,
                    dft_matmul: bool = False,
                    precision: str | None = None
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(T, framelength) time frames -> (mag**pow (T, F), phase (T, F)).

    ``dft_matmul=True`` computes the transform as matmuls instead
    of ``jnp.fft.rfft`` (see dft_matrices) — the f32 production plans' fast
    path; the default stays on the FFT, which the x64 oracle-parity gates
    pin bit-for-bit."""
    y = preemphasis(frames, preemph) * win[None, :]
    if dft_matmul:
        # ONE stacked (framelength, 2F) matmul (see dft_matrices_stacked),
        # and the phase leaves as a UNIT PHASOR [cos | sin] (T, 2F), not an
        # angle: the enhancement pipelines only ever apply real gains and
        # hand the phase straight back to synthesis_frames, so the
        # arctan2 here + cos/sin there — three transcendental passes
        # over (T, F) per utterance — are pure representation overhead.
        # re/sqrt(re^2+im^2) is one rsqrt and exactly the same rotation
        # (synthesis reconstructs amp*cos, amp*sin identically).
        cs, _ = dft_matrices_stacked(y.shape[-1], fftlength, y.dtype)
        reim = jnp.dot(y, cs, precision=precision or DFT_PRECISION)
        f = fftlength // 2 + 1
        re, im = reim[..., :f], reim[..., f:]
        r2 = re * re + im * im
        mag = r2 ** (pow_ / 2.0)
        # dtype-aware floor: bins with 0 < r2 < tiny would otherwise get a
        # clamped rsqrt and a phasor of norm << 1 (silent attenuation);
        # below the floor they take the r==0 convention instead —
        # arctan2(0, 0) = 0 -> cos 1, sin 0
        tiny = jnp.asarray(jnp.finfo(r2.dtype).tiny, r2.dtype)
        rs = jnp.where(r2 >= tiny, lax.rsqrt(jnp.maximum(r2, tiny)), 0.0)
        cosp = jnp.where(r2 >= tiny, re * rs, 1.0)
        sinp = im * rs
        phase = jnp.concatenate([cosp, sinp], axis=-1)
    else:
        spec = jnp.fft.rfft(y, n=fftlength, axis=-1)
        phase = jnp.angle(spec)
        mag = jnp.abs(spec) ** pow_
    if dc_bin > 0:
        mag = mag.at[:, :dc_bin].set(0.0)
    mag = mag + nonzerofloor
    return mag, phase


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def deemphasis(frames: jnp.ndarray, coeff: float) -> jnp.ndarray:
    """Per-frame IIR de-emphasis y[k] = x[k] + a*y[k-1] (synth_ifft_buff.m:26).

    Implemented as a closed-form matmul against a lower-triangular power
    matrix when coeff != 0 (framelength is only 640, and the common configs
    use coeff=0 so this path is rarely hot)."""
    if coeff == 0.0:
        return frames
    n = frames.shape[-1]
    k = jnp.arange(n)
    expo = k[:, None] - k[None, :]
    mat = jnp.where(expo >= 0, coeff ** expo.astype(frames.dtype), 0.0)
    return frames @ mat.T


def synthesis_frames(mag: jnp.ndarray, phase: jnp.ndarray, framelength: int,
                     fftlength: int, win: jnp.ndarray, pow_: float,
                     dc_bin_back: int, overlapscale: float,
                     preemph: float = 0.0,
                     dft_matmul: bool = False,
                     precision: str | None = None) -> jnp.ndarray:
    """(T, F) mag**pow + phase -> (T, framelength) windowed time frames.

    Matches synth_ifft_buff.m: dc rows zeroed BEFORE the pow-th root, real
    ifft of the conjugate-symmetric spectrum truncated to framelength,
    synthesis window, de-emphasis; times overlapscale (engine :354-363).
    ``dft_matmul=True`` runs the inverse transform as matmuls (see
    dft_matrices) — only the first ``framelength`` output samples are ever
    used, so the matmul computes exactly those."""
    if dc_bin_back > 0:
        mag = mag.at[:, :dc_bin_back].set(0.0)
    amp = mag ** (1.0 / pow_)
    if dft_matmul:
        _, cisi = dft_matrices_stacked(framelength, fftlength, amp.dtype)
        f = mag.shape[-1]
        if phase.shape[-1] == 2 * f:
            # unit-phasor representation from the matmul analysis path
            # ([cos | sin], see analysis_frames) — no cos/sin pass needed
            cosp, sinp = phase[..., :f], phase[..., f:]
        else:
            cosp, sinp = jnp.cos(phase), jnp.sin(phase)
        reim = jnp.concatenate([amp * cosp, amp * sinp], axis=-1)
        y = jnp.dot(reim, cisi, precision=precision or _idft_precision())
    else:
        spec = amp * jnp.exp(1j * phase)
        y = jnp.fft.irfft(spec, n=fftlength, axis=-1)[:, :framelength]
    y = y * win[None, :]
    y = deemphasis(y, preemph)
    return y * overlapscale


def overlap_add(frames: jnp.ndarray, frameshift: int) -> jnp.ndarray:
    """OLA of (T, framelength) frames at hop ``frameshift``.

    The reference's emit queue (filewise_run_IS16.m:162-165) is standard OLA
    with the first ``delay`` hops discarded; do that trim at the call site.
    Implemented as a strided scatter-add reshaped to avoid serial loops:
    frame t covers samples [t*hop, t*hop + framelength).
    """
    t, n = frames.shape
    if n % frameshift:       # static shapes: trace-time contract check
        raise ValueError(
            f"overlap_add requires framelength ({n}) divisible by "
            f"frameshift ({frameshift}); the reshape-based scatter-add "
            f"only tiles integer overlap ratios")
    ratio = n // frameshift  # frames overlapping any sample (=4 in live cfg)
    total = (t - 1) * frameshift + n
    # Split each frame into `ratio` hop-sized chunks; chunk c of frame t
    # lands at hop index t + c.  Sum over c with shifted zero-padding.
    chunks = frames.reshape(t, ratio, frameshift)
    out = jnp.zeros((t + ratio - 1, frameshift), frames.dtype)
    for c in range(ratio):
        out = out.at[c : c + t].add(chunks[:, c, :])
    return out.reshape(-1)[:total]


# ---------------------------------------------------------------------------
# Offline/training STFT (stft_fft.m semantics — different framing/DC rules)
# ---------------------------------------------------------------------------

def stft_batch_train(s: np.ndarray, framelength: int, frameshift: int,
                     fftlength: int, dc_bin: int, win: np.ndarray,
                     preemph: float) -> tuple[np.ndarray, np.ndarray]:
    """Training-path STFT matching stft_fft.m exactly (NumPy, float64).

    Differences vs the streaming analysis: frames start at sample 0 with no
    zero-prepend; iteration stops while start < len(s) - fftlength (tail
    truncation, stft_fft.m:21); magnitude is |Y| (pre-pow); DC bins are set
    to 1e-6 (not zeroed+floored); output allocated for floor(len/shift)
    frames so unproduced trailing columns remain all-zero (callers drop them
    via any(TF_mag,1) — run_basis_train.m:61).
    """
    s = np.asarray(s, dtype=np.float64).reshape(-1)
    n_alloc = len(s) // frameshift
    n_bins = fftlength // 2 + 1
    mag = np.zeros((n_bins, n_alloc))
    phase = np.zeros((n_bins, n_alloc))
    starts = []
    pos = 0
    # MATLAB: while size_crnt < length(s) - fftlen with 1-based size_crnt,
    # i.e. 0-based start < len - fftlen - 1.
    while pos < len(s) - fftlength - 1:
        starts.append(pos)
        pos += frameshift
    if starts:
        idx = np.asarray(starts)[:, None] + np.arange(framelength)[None, :]
        frames = s[idx]
        if preemph != 0.0:
            shifted = np.concatenate(
                [np.zeros((len(starts), 1)), frames[:, :-1]], axis=1)
            frames = frames - preemph * shifted
        frames = frames * win[None, :]
        spec = np.fft.rfft(frames, n=fftlength, axis=1)
        m = np.abs(spec)
        ph = np.angle(spec)
        m[:, :dc_bin] = 1e-6
        mag[:, : len(starts)] = m.T
        phase[:, : len(starts)] = ph.T
    return mag, phase
