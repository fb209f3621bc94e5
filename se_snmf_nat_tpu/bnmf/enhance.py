"""Bayesian-NMF speech enhancer (Mohammadiha TASLP 2013) — the
reference's third algorithm slot, rebuilt in JAX.

Everything /root/reference/proc_BNMF_nmoh.m itself pins down is
reproduced exactly:

  * framing: alen=512 / ulen=256 (:23), periodic Hann normalized by
    sqrt(sum(win^2)) (:117-119), per-frame fft -> 257 bins (:122),
    magnitude scaled by spec_scale=5 (:42,123), synthesis by
    conj-symmetric ifft of (1/5)*Est*exp(i*angle(Y)) with DC/Nyquist
    forced real, scaled back by norm_coef, plain overlap-add (:131-135);
  * speech model: R_x-component VB-NMF on the unit-variance speech
    signal's scaled magnitude spectrogram, 100 iterations (:46-53);
  * online noise model: 15 components trained on the first 15*ulen
    samples of the mixture (unit-variance normalized), 1000 iterations,
    then posterior shapes clamped to >= 200
    (adjust_ShapeparamBasis(200), :86-104);
  * a 50-column noise-frame buffer seeded with the init spectrogram
    ("buffer n in section III.B in the paper", :89-97);
  * activation prior shapes phi_s=0 (vague) and phi_n=a_noise=100
    (UserData [0 a_noise], :110);
  * WADA long-term SNR tracking: G-statistic over the past 50*ulen
    samples, quadratic fit through the published (SNR, G) table, 0.998
    recursive smoothing, no estimate for the first 50 frames (:139-155).

What the wrapper delegates to the absent @NMF class
(BNMF_Factorization_oneFrame, src/BNMF_nmoh/ — not in the reference
repo) is reconstructed from the paper and documented here as deviations:

  * MMSE magnitude estimate: under the Poisson compound model,
    E[speech part | total = y] = y * lam_s/(lam_s+lam_n) with lam the
    posterior-mean reconstructions — a Wiener-style gain (TASLP §III.A);
  * temporal activation priors: prior means are exponential smoothings
    of past posterior means (§III.C), smoothing factor prior_smooth
    (free choice: 0.9);
  * noise-dominated frame detection: a frame is pushed into the buffer
    when its instantaneous NMF SNR falls below the long-term WADA SNR
    (§III.B); the noise basis is refit on the buffer every refit_every
    pushes (the wrapper's newNoiseInBuffer arithmetic hints at 10) with
    the previous posterior down-weighted by rho as the prior (streaming
    VB) and shapes re-clamped.

The per-frame loop is a single ``lax.scan`` (carry: noise-basis
posterior, prior means, noise buffer ring, WADA ring, long-term SNR);
the per-frame VB inference is a static-length inner scan of GEMM-shaped
updates (bnmf/vb.py).  ``method='supervised'`` instead factorizes ALL
frames in one batched solve (columns = frames) — the matmul-friendly
offline plan (no temporal adaptation, like the reference's supervised
branch :62-81).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from se_snmf_nat_tpu.bnmf.vb import (
    GammaPost, _h_block, clamp_min_shape, init_train, vb_h_infer, vb_train)
from se_snmf_nat_tpu.io.wavio import enhanced_quantize

_EPS = 2.220446049250313e-16        # MATLAB eps, used in the WADA log
_FLR = 1e-30

# WADA calibration: quadratic through the published table
# (proc_BNMF_nmoh.m:150-152; Kim & Stern Interspeech 2008)
_WADA_SNRS = np.array([-5.0, 0.0, 10.0, 20.0])
_WADA_G = np.array([0.423, 0.442, 0.642, 0.885])
_WADA_POLY = np.polyfit(_WADA_SNRS, _WADA_G, 2)     # p1 x^2 + p2 x + p3


class BnmfParams(NamedTuple):
    alen: int = 512                 # analysis length (:23)
    ulen: int = 256                 # update (hop) length (:23)
    spec_scale: float = 5.0         # (:42)
    k_speech: int = 100             # p.R_x (:48)
    k_noise: int = 15               # online (:85); supervised uses R_d
    a_noise: float = 100.0          # phi^(n) online (:87); 10 supervised
    train_iters: int = 100          # speech model max_it (:51)
    noise_init_iters: int = 1000    # online noise max_it (:99)
    min_noise_shape: float = 200.0  # adjust_ShapeparamBasis (:104)
    n_infer: int = 25               # per-frame VB iterations (class
                                    # internal; free choice)
    k_noise_supervised: int = 100   # num_noise_basis = p.R_d (:68)
    buffer_len: int = 50            # noise buffer columns (:89)
    refit_every: int = 10           # pushes between refits (free: the
                                    # wrapper's +10 counter)
    n_refit: int = 10               # VB iterations per refit (free)
    rho: float = 0.9                # prior forgetting on refit (free)
    prior_smooth: float = 0.9       # activation-prior smoothing (free)
    snr_smooth: float = 0.998       # WADA recursion (:154)
    wada_win: int = 50              # frames in the G window (:145)
    init_hops: int = 15             # noise-only head, in hops (:88)


class BnmfModel(NamedTuple):
    """Trained speech model: basis posterior + mean activation levels
    (the data-driven init/prior means for inference)."""
    w: GammaPost                    # (F, K_s)
    u0: jnp.ndarray                 # (K_s, 1) mean training activation


def _safe_std(x: np.ndarray) -> float:
    """MATLAB-style unit-variance normalizer with a silence guard: a
    zero-variance stretch (digital silence, muted capture) must not put
    NaN through the whole pipeline (the wrapper divides unguarded,
    proc_BNMF_nmoh.m:31,88 — a deliberate robustness deviation)."""
    s = float(np.sqrt(np.var(np.asarray(x, np.float64), ddof=1)))
    return s if s > 0.0 and np.isfinite(s) else 1.0


def _window(alen: int) -> np.ndarray:
    n = np.arange(alen)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / alen)    # hann periodic
    return win / np.sqrt(np.sum(win ** 2))              # :118-119


def _frame(x: np.ndarray, alen: int, ulen: int) -> np.ndarray:
    """(T, alen) frames at hop ulen, T = floor(len/ulen) - 1 (:121,129)."""
    t = len(x) // ulen - 1
    if t <= 0:
        return np.zeros((0, alen), x.dtype)
    idx = np.arange(alen)[None, :] + ulen * np.arange(t)[:, None]
    return x[idx]


def spectrogram(x: np.ndarray, p: BnmfParams) -> np.ndarray:
    """Scaled magnitude spectrogram (F, T) of a raw signal — the
    MySpectrogram role (assumed same framing/window as the main loop)."""
    frames = _frame(np.asarray(x, np.float64), p.alen, p.ulen)
    spec = np.fft.rfft(frames * _window(p.alen)[None, :], axis=1)
    return p.spec_scale * np.abs(spec).T


def train_speech_model(speech: np.ndarray, p: BnmfParams,
                       dtype=jnp.float32, seed: int = 0,
                       trace_bound: bool = False):
    """VB speech model from a clean-speech signal (proc_BNMF_nmoh.m:46-53:
    unit-variance normalize, 5x magnitude spectrogram, R_x components,
    100 iterations).  Returns (BnmfModel, bound_trace)."""
    speech = np.asarray(speech, np.float64)
    speech = speech / _safe_std(speech)                 # MATLAB var (:31)
    spect = spectrogram(speech, p)
    w0, h0, b0w, b0h = init_train(spect, p.k_speech, seed=seed)
    w, h, trace = vb_train(
        jnp.asarray(spect, dtype), jnp.asarray(w0, dtype),
        jnp.asarray(h0, dtype), b0w, b0h, n_iter=p.train_iters,
        trace_bound=trace_bound)
    u0 = jnp.mean(h.mean, axis=1, keepdims=True)
    return BnmfModel(w, u0), trace


def _train_noise_init(mixed: np.ndarray, p: BnmfParams, dtype, seed=1):
    """Online-mode noise init from the first init_hops*ulen mixture
    samples (:85-99): unit-variance normalize, spectrogram, K_noise
    components, noise_init_iters, shape clamp."""
    head = np.asarray(mixed[: p.init_hops * p.ulen], np.float64)
    head = head / _safe_std(head)
    nos = spectrogram(head, p)
    w0, h0, b0w, b0h = init_train(nos, p.k_noise, seed=seed)
    w, h, _ = vb_train(
        jnp.asarray(nos, dtype), jnp.asarray(w0, dtype),
        jnp.asarray(h0, dtype), b0w, b0h, n_iter=p.noise_init_iters)
    w = clamp_min_shape(w, p.min_noise_shape)
    u0 = jnp.mean(h.mean, axis=1, keepdims=True)
    return w, u0, nos


def _noise_refit(wn: GammaPost, buf, mask, p: BnmfParams, b0h: float):
    """Streaming-VB refit of the noise basis on the (F, buffer_len)
    buffer.  Prior = previous posterior down-weighted by rho; invalid
    buffer columns are masked out of every statistic."""
    x = jnp.maximum(buf, _FLR)
    k = wn.shape.shape[1]
    a0_w = p.rho * wn.shape
    r0_w = p.rho / wn.scale
    u = jnp.full((k, buf.shape[1]), b0h, x.dtype)
    h = GammaPost(jnp.ones_like(u), u)
    w = wn

    def step(carry, _):
        w, h = carry
        lw = w.explog()
        h = _h_block(x, lw, jnp.sum(w.mean, 0)[:, None], h, 1.0, 1.0 / b0h)
        lh = h.explog() * mask[None, :]
        eh_rowsum = jnp.sum(h.mean * mask[None, :], 1)[None, :]
        lam = jnp.maximum(lw @ lh, _FLR)
        sw = lw * (((x / lam) * mask[None, :]) @ lh.T)
        shape = a0_w + sw
        scale = 1.0 / (r0_w + eh_rowsum)
        w = GammaPost(jnp.maximum(shape, 1e-12), scale)
        return (w, h), None

    (w, _), _ = jax.lax.scan(step, (w, h), None, length=p.n_refit)
    return clamp_min_shape(w, p.min_noise_shape)


class BnmfEnhancer:
    """Online (default) or supervised BNMF enhancer.

    ``model``: a trained BnmfModel, or pass ``speech=<signal>`` to train
    one here.  Online mode needs nothing else (noise model self-
    initializes from the head of each input); supervised mode needs
    ``noise=<signal>`` (trains a fixed noise model, no adaptation).
    """

    def __init__(self, model: BnmfModel | None = None, *,
                 speech: np.ndarray | None = None,
                 noise: np.ndarray | None = None,
                 method: str = "online",
                 params: BnmfParams | None = None,
                 dtype=jnp.float32, seed: int = 0):
        self.p = params or BnmfParams()
        if self.p.alen != 2 * self.p.ulen:
            # _frame/_ola implement exactly the reference's 50%-overlap
            # sqrt-Hann chain (proc_BNMF_nmoh.m:23); other ratios would
            # silently mis-frame, so reject them up front
            raise ValueError(
                f"BnmfParams requires alen == 2*ulen "
                f"(got alen={self.p.alen}, ulen={self.p.ulen})")
        self.dtype = dtype
        self.method = method
        if model is None:
            if speech is None:
                raise ValueError("need a BnmfModel or a speech signal")
            model, _ = train_speech_model(speech, self.p, dtype, seed)
        self.model = model
        self.noise_model = None
        if method == "supervised":
            if noise is None:
                raise ValueError("supervised mode needs a noise signal")
            p = self.p
            noise = np.asarray(noise, np.float64)
            noise = noise / _safe_std(noise)
            spect = spectrogram(noise, p)
            # supervised noise rank is R_d-scale (num_noise_basis = p.R_d,
            # proc_BNMF_nmoh.m:68), NOT the online path's 15-atom model
            w0, h0, b0w, b0h = init_train(spect, p.k_noise_supervised,
                                          seed=seed + 1)
            w, h, _ = vb_train(
                jnp.asarray(spect, dtype), jnp.asarray(w0, dtype),
                jnp.asarray(h0, dtype), b0w, b0h, n_iter=p.train_iters)
            self.noise_model = BnmfModel(
                w, jnp.mean(h.mean, axis=1, keepdims=True))
        self._win = _window(self.p.alen)
        self._scan = None           # built lazily (closes over posteriors)

    # ------------------------------------------------------------------
    def _build_scan(self):
        p = self.p
        dt = self.dtype
        ws = self.model.w
        lw_s = ws.explog().astype(dt)
        ew_s = ws.mean.astype(dt)
        ews_colsum = jnp.sum(ew_s, 0)[:, None]
        k_s = lw_s.shape[1]
        k_n = p.k_noise
        phi = jnp.concatenate([jnp.zeros((k_s, 1), dt),
                               jnp.full((k_n, 1), p.a_noise, dt)])
        poly = jnp.asarray(_WADA_POLY, dt)

        def infer(y, wn: GammaPost, u_s, u_n):
            lw = jnp.concatenate([lw_s, wn.explog().astype(dt)], axis=1)
            ew = jnp.concatenate([ew_s, wn.mean.astype(dt)], axis=1)
            ew_colsum = jnp.concatenate(
                [ews_colsum, jnp.sum(wn.mean, 0)[:, None]], axis=0)
            u = jnp.concatenate([u_s, u_n], axis=0)
            inv_rate = jnp.where(phi > 0.0, phi / jnp.maximum(u, _FLR), 0.0)
            h = GammaPost(jnp.maximum(phi, 1.0),
                          jnp.maximum(u, _FLR) / jnp.maximum(phi, 1.0))

            def it(h, _):
                return _h_block(y, lw, ew_colsum, h, phi, inv_rate), None

            h, _ = jax.lax.scan(it, h, None, length=p.n_infer)
            eh = h.mean
            lam_s = ew[:, :k_s] @ eh[:k_s]
            lam_n = ew[:, k_s:] @ eh[k_s:]
            return eh, lam_s, lam_n

        b0h_buf = 1.0               # refit H prior mean (vague)

        def step(carry, xs):
            (wn_a, wn_s, u_s, u_n, buf, bmask, bptr, newc,
             ring1, ring2, rptr, snr_lt) = carry
            frame, l = xs           # (alen,), frame index 1-based
            wn = GammaPost(wn_a, wn_s)

            spec = jnp.fft.rfft(frame * jnp.asarray(self._win, dt))
            y = (p.spec_scale * jnp.abs(spec)).astype(dt)[:, None]
            y = jnp.maximum(y, _FLR)

            eh, lam_s, lam_n = infer(y, wn, u_s, u_n)
            gain = lam_s / jnp.maximum(lam_s + lam_n, _FLR)
            s_hat = gain * y

            # temporal priors (TASLP §III.C): exponential smoothing
            sm = p.prior_smooth
            u_s = sm * u_s + (1.0 - sm) * eh[:k_s]
            u_n = sm * u_n + (1.0 - sm) * eh[k_s:]

            # noise-dominated detection + buffer push (§III.B)
            e_s = jnp.sum(s_hat ** 2)
            e_n = jnp.sum((y - s_hat) ** 2)
            inst = 10.0 * jnp.log10(jnp.maximum(e_s, _FLR)
                                    / jnp.maximum(e_n, _FLR))
            push = jnp.logical_or(l <= p.init_hops, inst < snr_lt)
            buf = jnp.where(push, buf.at[:, bptr].set(y[:, 0]), buf)
            bmask = jnp.where(push, bmask.at[bptr].set(1.0), bmask)
            bptr = jnp.where(push, (bptr + 1) % p.buffer_len, bptr)
            newc = newc + push.astype(jnp.int32)

            # periodic streaming refit of the noise basis
            do_refit = newc >= p.refit_every

            def refit(wn):
                return _noise_refit(wn, buf, bmask, p, b0h_buf)

            wn = jax.lax.cond(do_refit, refit, lambda w: w, wn)
            newc = jnp.where(do_refit, 0, newc)

            # WADA long-term SNR (:139-155): stats of the hop ending at
            # this frame's midpoint, window = last wada_win hops
            hop = frame[: p.ulen]
            ring1 = ring1.at[rptr].set(jnp.sum(jnp.abs(hop)))
            ring2 = ring2.at[rptr].set(jnp.sum(jnp.log(jnp.abs(hop) + _EPS)))
            rptr = (rptr + 1) % p.wada_win
            n_samp = p.wada_win * p.ulen
            g = (jnp.log(jnp.sum(ring1) / n_samp)
                 - jnp.sum(ring2) / n_samp)
            # min-|root| of p1 x^2 + p2 x + (p3 - g) (:153); complex pair
            # -> common real part (deviation: MATLAB would propagate the
            # complex root into the recursion)
            p1, p2, p3 = poly[0], poly[1], poly[2]
            disc = p2 * p2 - 4.0 * p1 * (p3 - g)
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            r_a = (-p2 + sq) / (2.0 * p1)
            r_b = (-p2 - sq) / (2.0 * p1)
            root = jnp.where(disc >= 0.0,
                             jnp.where(jnp.abs(r_a) < jnp.abs(r_b),
                                       r_a, r_b),
                             -p2 / (2.0 * p1))
            snr_lt = jnp.where(l > p.wada_win,
                               p.snr_smooth * snr_lt
                               + (1.0 - p.snr_smooth) * root,
                               snr_lt)

            # synthesis (:131-135)
            est = (s_hat[:, 0] / p.spec_scale) \
                * jnp.exp(1j * jnp.angle(spec))
            est = est.at[0].set(jnp.real(est[0]).astype(est.dtype))
            est = est.at[-1].set(jnp.real(est[-1]).astype(est.dtype))
            y_t = jnp.fft.irfft(est * self._norm_coef, n=p.alen)

            carry = (wn.shape, wn.scale, u_s, u_n, buf, bmask, bptr, newc,
                     ring1, ring2, rptr, snr_lt)
            return carry, y_t.astype(dt)

        return step

    # ------------------------------------------------------------------
    @property
    def _norm_coef(self):
        n = np.arange(self.p.alen)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.p.alen)
        return float(np.sqrt(np.sum(w ** 2)))           # :117

    def _ola(self, frames: np.ndarray) -> np.ndarray:
        """Plain overlap-add of (T, alen) frames at hop ulen into a
        (T+1)*ulen signal (:129-135)."""
        p = self.p
        t = frames.shape[0]
        if t == 0:
            return np.zeros(0)
        fh, sh = frames[:, : p.ulen], frames[:, p.ulen:]
        out = np.zeros(((t + 1), p.ulen))
        out[:t] += fh
        out[1:] += sh
        return out.reshape(-1)

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        # Scale coherence (deviation): the wrapper trains the noise init
        # on a unit-variance head (:88) but streams raw int16-scale
        # magnitudes (:34-36,123) — only workable if the absent class
        # rescales internally.  We normalize the whole mixture by the
        # noise-head std (supervised: its own std) so the stream and the
        # noise model share one scale, and scale the output back.
        p = self.p
        x = np.asarray(x, np.float64)
        frames_raw = _frame(x, p.alen, p.ulen)
        t = frames_raw.shape[0]
        if t == 0:
            return np.zeros(0, np.int16 if quantize else np.float64)
        if self.method == "supervised":
            sigma = _safe_std(x)
        else:
            sigma = self.head_sigma(x)
        frames = frames_raw / sigma
        dt = self.dtype
        if self.method == "supervised":
            y_t = self._enhance_supervised(frames)
        else:
            carry = self.init_online_carry(x)
            # frame counts round up to a bucket with masked padding so a
            # directory of mixed-length files compiles one scan per BUCKET
            # (the repo's frame_bucket convention), not per
            # length — padding frames freeze the carry and emit zeros
            bucket = 128
            t_pad = -(-t // bucket) * bucket
            frames_p = np.concatenate(
                [frames, np.zeros((t_pad - t, p.alen))]) \
                if t_pad != t else frames
            if self._scan is None:
                step = self._build_scan()

                @jax.jit
                def run(carry, frames, n_valid):
                    idx = jnp.arange(frames.shape[0], dtype=jnp.int32)

                    def masked(c, xs):
                        frame, l, i = xs
                        new_c, out = step(c, (frame, l))
                        ok = i < n_valid
                        c_out = jax.tree.map(
                            lambda a, b: jnp.where(ok, a, b), new_c, c)
                        return c_out, jnp.where(ok, out,
                                                jnp.zeros_like(out))

                    return jax.lax.scan(
                        masked, carry,
                        (frames, 1 + idx, idx))

                self._scan = run
            _, y_t = self._scan(carry, jnp.asarray(frames_p, dt),
                                jnp.asarray(t, jnp.int32))
            y_t = np.asarray(y_t, np.float64)[:t]
        out = self._ola(y_t) * sigma
        return enhanced_quantize(out) if quantize else out

    def init_online_carry(self, x_head: np.ndarray):
        """Online-mode scan carry from the mixture head (needs at least
        init_hops*ulen samples): trains the noise init (:85-99) and seeds
        the noise-frame buffer (:91-97).  Shared by offline enhance() and
        the push-based BnmfStreamingSession."""
        p, dt = self.p, self.dtype
        wn, u_n0, nos = _train_noise_init(np.asarray(x_head, np.float64),
                                          p, dt)
        f = nos.shape[0]
        buf = np.zeros((f, p.buffer_len))
        bmask = np.zeros(p.buffer_len)
        ncols = min(nos.shape[1], p.buffer_len)
        buf[:, :ncols] = nos[:, -ncols:]            # :91-97
        bmask[:ncols] = 1.0
        return (wn.shape.astype(dt), wn.scale.astype(dt),
                self.model.u0.astype(dt), u_n0.astype(dt),
                jnp.asarray(buf, dt), jnp.asarray(bmask, dt),
                jnp.asarray(ncols % p.buffer_len, jnp.int32),
                jnp.asarray(0, jnp.int32),
                jnp.zeros(p.wada_win, dt), jnp.zeros(p.wada_win, dt),
                jnp.asarray(0, jnp.int32), jnp.asarray(0.0, dt))

    def head_sigma(self, x_head: np.ndarray) -> float:
        """The noise-head scale the stream is normalized by (see
        enhance() scale-coherence note)."""
        head = np.asarray(x_head, np.float64)[: self.p.init_hops
                                              * self.p.ulen]
        return _safe_std(head)

    def _enhance_supervised(self, frames: np.ndarray) -> np.ndarray:
        """All frames in one batched VB solve — the offline batched plan."""
        p = self.p
        dt = self.dtype
        spec = np.fft.rfft(frames * self._win[None, :], axis=1)
        y = jnp.asarray(p.spec_scale * np.abs(spec).T, dt)
        k_s = self.model.w.shape.shape[1]
        w = GammaPost(
            jnp.concatenate([self.model.w.shape,
                             self.noise_model.w.shape], 1).astype(dt),
            jnp.concatenate([self.model.w.scale,
                             self.noise_model.w.scale], 1).astype(dt))
        t = y.shape[1]
        k_n = self.noise_model.w.mean.shape[1]   # k_noise_supervised
        # bucket the frame axis so mixed-length files share one compiled
        # executable (columns are independent in the H inference; padded
        # columns are trimmed after) — same plan as the online path
        t_pad = -(-t // 128) * 128
        if t_pad != t:
            y = jnp.pad(y, ((0, 0), (0, t_pad - t)), constant_values=1.0)
        u = jnp.concatenate(
            [jnp.broadcast_to(self.model.u0, (k_s, t_pad)),
             jnp.broadcast_to(self.noise_model.u0, (k_n, t_pad))])
        phi = jnp.concatenate(
            [jnp.zeros((k_s, 1), dt),
             jnp.full((k_n, 1), 10.0, dt)])             # a_noise=10 (:67)
        h = vb_h_infer(y, w, u.astype(dt), phi, n_iter=p.n_infer)
        eh = h.mean[:, :t]
        lam_s = w.mean[:, :k_s] @ eh[:k_s]
        lam_n = w.mean[:, k_s:] @ eh[k_s:]
        gain = np.asarray(lam_s / jnp.maximum(lam_s + lam_n, _FLR),
                          np.float64)
        est = gain.T * np.abs(spec) * np.exp(1j * np.angle(spec))
        est[:, 0] = est[:, 0].real
        est[:, -1] = est[:, -1].real
        return np.fft.irfft(est * self._norm_coef, n=p.alen, axis=1)
