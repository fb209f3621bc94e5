"""OM-LSA / IMCRA baseline enhancer — JAX scan engine.

Reference: proc_IMCRA.m (Cohen 2003 "omlsa3"; the `p.NMF_algorithm='IMCRA'`
baseline of the campaign scripts, run_IMCRA.m:7-31).  Re-design:

  host:   int16 samples -> (T, 512) stride-128 frame matrix
  device: batched rfft -> lax.scan(IMCRA noise tracking + OM-LSA gain)
          -> batched irfft -> overlap-add
  host:   int16 quantization (the reference writes raw int16 directly,
          proc_IMCRA.m:360-373 — no pcm2wav rescale on this path)

The per-frame recurrences (minima tracking S/Smin/St/Smint with Vwin=15
sub-window switching, speech-presence q/p-hat, long-term noise PSD) are the
scan carry; the FFTs — the only O(M log M) work — batch outside the scan.
Gated frames (leading zeros / silent frames, proc_IMCRA.m:145,355-359) are
handled with lax.cond so state stays untouched exactly as the reference
skips them.  Utterances batch with vmap (enhance_batch).

The float64 oracle (oracle/imcra_np.py) pins the semantics; tests gate the
scan against it bit-for-bit in x64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from se_snmf_nat_tpu.oracle.imcra_np import (
    ImcraParams, _iround, imcra_windows, matlab_hanning)
from se_snmf_nat_tpu.dsp.stft import pack_samples_for_upload
from se_snmf_nat_tpu.utils.matlab_compat import (
    matlab_int16_write, matlab_int16_write_jax)
from se_snmf_nat_tpu.utils.special import expint_e1


class ImcraState(NamedTuple):
    lambda_d: jnp.ndarray        # (F,) noise PSD driving the gain
    eta_2term: jnp.ndarray       # (F,) DD prior carry GH1^2*gamma
    xi: jnp.ndarray              # (F,) smoothed prior SNR
    xi_frame: jnp.ndarray        # scalar
    xi_m_db: jnp.ndarray         # scalar (frame-prior peak memory)
    s: jnp.ndarray               # (F,) smoothed periodogram
    st: jnp.ndarray              # (F,) minima-controlled smoothed
    smin: jnp.ndarray
    smint: jnp.ndarray
    smact: jnp.ndarray
    smactt: jnp.ndarray
    sw: jnp.ndarray              # (F, Nwin) sub-window minima ring
    swt: jnp.ndarray
    lambda_dav: jnp.ndarray
    lambda_dav_long: jnp.ndarray
    sy: jnp.ndarray
    l_mod_lswitch: jnp.ndarray   # int32
    l_fnz: jnp.ndarray           # int32 first-nonzero frame counter
    fnz_flag: jnp.ndarray        # bool


def _conv_same(x: jnp.ndarray, kernel: jnp.ndarray, w: int) -> jnp.ndarray:
    """conv(b, x) central slice, matching the oracle's np.convolve slice.

    Unrolled shift-add instead of jnp.convolve: a conv op inside the scan
    body lowers to convolution machinery and inflated compile time by
    minutes on the previous accelerator; 2w+1 shifted adds of a 257-vector
    fuse into trivial elementwise code.
    """
    n = x.shape[0]
    xp = jnp.pad(x, (w, w))
    out = jnp.zeros_like(x)
    for j in range(2 * w + 1):
        out = out + kernel[j] * lax.dynamic_slice(xp, (2 * w - j,), (n,))
    return out


def make_imcra_step(p: ImcraParams, dtype=jnp.float32):
    m21 = p.m21
    b = jnp.asarray(matlab_hanning(2 * p.w + 1), dtype)
    b = b / jnp.sum(b)
    b_xi_l = jnp.asarray(matlab_hanning(2 * p.w_xi_local + 1), dtype)
    b_xi_l = b_xi_l / jnp.sum(b_xi_l)
    b_xi_g = jnp.asarray(matlab_hanning(2 * p.w_xi_global + 1), dtype)
    b_xi_g = b_xi_g / jnp.sum(b_xi_g)

    k_u = min(_iround(p.f_u / p.fs * p.m + 1), m21)
    k_l = _iround(p.f_l / p.fs * p.m + 1)
    k2 = _iround(500.0 / p.fs * p.m + 1)
    k3 = _iround(3500.0 / p.fs * p.m + 1)
    eta_min = p.eta_min
    g_f = p.g_f
    nonstat_factor = 2.0 if p.nonstat == "high" else 1.4685
    tone_len = m21 - 15          # lambda_dav_long(8:M21-8) slice length

    def processed(state: ImcraState, ya2, l) -> tuple[ImcraState, jnp.ndarray]:
        is_first = l == state.l_fnz
        warmup = l < 14 + state.l_fnz

        lambda_d = jnp.where(is_first, ya2, state.lambda_d)
        gamma = ya2 / jnp.maximum(lambda_d, 1e-10)
        eta = p.alpha_eta * state.eta_2term \
            + (1 - p.alpha_eta) * jnp.maximum(gamma - 1, 0)
        eta = jnp.maximum(eta, eta_min)
        v = gamma * eta / (1 + eta)

        sf = _conv_same(ya2, b, p.w)
        s = jnp.where(is_first, sf, p.alpha_s * state.s + (1 - p.alpha_s) * sf)
        sy = jnp.where(is_first, ya2, state.sy)
        lambda_dav = jnp.where(is_first, ya2, state.lambda_dav)
        st_mid = jnp.where(is_first, sf, state.st)

        smin = jnp.where(warmup, s, jnp.minimum(state.smin, s))
        smact = jnp.where(warmup, s, jnp.minimum(state.smact, s))

        i_f = ((ya2 < p.delta_y * p.bmin * smin)
               & (s < p.delta_s * p.bmin * smin)).astype(dtype)
        conv_i = _conv_same(i_f, b, p.w)
        conv_y = _conv_same(i_f * ya2, b, p.w)
        sft = jnp.where(conv_i > 0,
                        conv_y / jnp.where(conv_i > 0, conv_i, 1.0), st_mid)
        st = jnp.where(warmup, s,
                       p.alpha_s * st_mid + (1 - p.alpha_s) * sft)
        smint = jnp.where(warmup, st, jnp.minimum(state.smint, st))
        smactt = jnp.where(warmup, st, jnp.minimum(state.smactt, st))

        ref_min = smin if p.nonstat == "low" else smint
        gamma_mint = ya2 / p.bmin / jnp.maximum(ref_min, 1e-10)
        zetat = s / p.bmin / jnp.maximum(ref_min, 1e-10)
        band = (gamma_mint > 1) & (gamma_mint < p.delta_yt) & (zetat < p.delta_s)
        qhat = jnp.where(band, (p.delta_yt - gamma_mint) / (p.delta_yt - 1), 1.0)
        phat = jnp.where(
            band,
            1.0 / (1 + qhat / jnp.maximum(1 - qhat, 1e-300)
                   * (1 + eta) * jnp.exp(-v)),
            0.0)
        phat = jnp.where((gamma_mint >= p.delta_yt) | (zetat >= p.delta_s),
                         1.0, phat)

        alpha_dt = p.alpha_d + (1 - p.alpha_d) * phat
        lambda_dav = alpha_dt * lambda_dav + (1 - alpha_dt) * ya2
        a_long = p.alpha_d_long + (1 - p.alpha_d_long) * phat
        lambda_dav_long = jnp.where(
            warmup, lambda_dav,
            a_long * state.lambda_dav_long + (1 - a_long) * ya2)

        # sub-window minima switch (proc_IMCRA.m:231-246)
        lswitch = state.l_mod_lswitch + 1
        fire = lswitch == p.vwin
        seed = l == (p.vwin - 1 + state.l_fnz)
        sw_seed = jnp.tile(s[:, None], (1, p.nwin))
        swt_seed = jnp.tile(st[:, None], (1, p.nwin))
        sw_roll = jnp.concatenate([state.sw[:, 1:], smact[:, None]], axis=1)
        swt_roll = jnp.concatenate([state.swt[:, 1:], smactt[:, None]], axis=1)
        sw = jnp.where(fire, jnp.where(seed, sw_seed, sw_roll), state.sw)
        swt = jnp.where(fire, jnp.where(seed, swt_seed, swt_roll), state.swt)
        roll = fire & ~seed
        smin = jnp.where(roll, sw_roll.min(axis=1), smin)
        smint = jnp.where(roll, swt_roll.min(axis=1), smint)
        smact = jnp.where(roll, s, smact)
        smactt = jnp.where(roll, st, smactt)
        lswitch = jnp.where(fire, 0, lswitch).astype(jnp.int32)

        lambda_d = nonstat_factor * lambda_dav

        # a-priori speech-absence probability (proc_IMCRA.m:257-310)
        xi = p.alpha_xi * state.xi + (1 - p.alpha_xi) * eta
        xi_local = _conv_same(xi, b_xi_l, p.w_xi_local)
        xi_global = _conv_same(xi, b_xi_g, p.w_xi_global)
        xi_frame = jnp.mean(xi[k_l - 1: k_u])
        dxi = xi_frame - state.xi_frame
        db = lambda a: jnp.where(
            a > 0, 10.0 * jnp.log10(jnp.maximum(a, 1e-300)), -100.0)
        xi_local_db, xi_global_db, xi_frame_db = db(xi_local), db(xi_global), db(xi_frame)

        def presence(x_db, lo, hi):
            lin = p.p_min + (x_db - lo) / (hi - lo) * (1 - p.p_min)
            return jnp.where(x_db <= lo, p.p_min, jnp.where(x_db < hi, lin, 1.0))

        p_local = presence(xi_local_db, p.xi_ll_db, p.xi_lu_db)
        p_global = presence(xi_global_db, p.xi_gl_db, p.xi_gu_db)

        m_p_local = jnp.mean(p_local[2: k2 + k3 - 3])
        reset = m_p_local < 0.25
        p_local = jnp.where(
            reset & (jnp.arange(m21) >= k2 - 1) & (jnp.arange(m21) <= k3 - 1),
            p.p_min, p_local)
        if p.tone_flag:
            seg = lambda_dav_long
            tone = seg[7: 7 + tone_len] > 2.5 * (seg[9: 9 + tone_len]
                                                 + seg[5: 5 + tone_len])
            tone_mask = jnp.zeros(m21, bool)
            for off in (6, 7, 8):
                tone_mask = tone_mask.at[off: off + tone_len].set(
                    tone_mask[off: off + tone_len] | tone)
            tone_on = (m_p_local < 0.5) & (l > 120)
            p_local = jnp.where(tone_on & tone_mask, p.p_min, p_local)

        lin_f = p.p_min + (xi_frame_db - state.xi_m_db - p.xi_fl_db) \
            / (p.xi_fu_db - p.xi_fl_db) * (1 - p.p_min)
        p_frame = jnp.where(
            xi_frame_db <= p.xi_fl_db, p.p_min,
            jnp.where(dxi >= 0, 1.0,
                      jnp.where(xi_frame_db >= state.xi_m_db + p.xi_fu_db, 1.0,
                                jnp.where(xi_frame_db <= state.xi_m_db + p.xi_fl_db,
                                          p.p_min, lin_f))))
        xi_m_db = jnp.where((xi_frame_db > p.xi_fl_db) & (dxi >= 0),
                            jnp.clip(xi_frame_db, p.xi_ml_db, p.xi_mu_db),
                            state.xi_m_db)

        q = 1 - p_global * p_local * p_frame if p.broad_flag \
            else 1 - p_local * p_frame
        q = jnp.minimum(q, p.q_max)

        # posterior + OM-LSA gain (proc_IMCRA.m:312-342)
        gamma2 = ya2 / jnp.maximum(lambda_d, 1e-10)
        eta2 = p.alpha_eta * state.eta_2term \
            + (1 - p.alpha_eta) * jnp.maximum(gamma2 - 1, 0)
        eta2 = jnp.maximum(eta2, eta_min)
        v2 = gamma2 * eta2 / (1 + eta2)
        ph1 = jnp.where(
            q < 0.9,
            1.0 / (1 + q / jnp.maximum(1 - q, 1e-300)
                   * (1 + eta2) * jnp.exp(-v2)),
            0.0)
        wiener = eta2 / (1 + eta2)
        gh1 = jnp.where(v2 > 5, wiener,
                        jnp.where(v2 > 0,
                                  wiener * jnp.exp(0.5 * expint_e1(
                                      jnp.maximum(v2, 1e-300))),
                                  1.0))
        if p.tone_flag:
            ldg = lambda_d.at[3: m21 - 3].set(jnp.minimum(
                jnp.minimum(lambda_d[3: m21 - 3], lambda_d[0: m21 - 6]),
                lambda_d[6: m21]))
            sy = 0.8 * sy + 0.2 * ya2
            gh0 = g_f * jnp.sqrt(ldg / (sy + 1e-10))
        else:
            gh0 = jnp.full((m21,), g_f, dtype)
        g = gh1 ** ph1 * gh0 ** (1 - ph1)
        eta_2term = gh1 * gh1 * gamma2

        new = ImcraState(
            lambda_d=lambda_d, eta_2term=eta_2term, xi=xi,
            xi_frame=xi_frame, xi_m_db=xi_m_db, s=s, st=st, smin=smin,
            smint=smint, smact=smact, smactt=smactt, sw=sw, swt=swt,
            lambda_dav=lambda_dav, lambda_dav_long=lambda_dav_long, sy=sy,
            l_mod_lswitch=lswitch, l_fnz=state.l_fnz,
            fnz_flag=jnp.asarray(True))
        return new, g

    def step(state: ImcraState, xs):
        ya2, l, first_nz, any_nz = xs
        process = jnp.where(state.fnz_flag, any_nz, first_nz)

        def skip(op):
            state, ya2, l = op
            l_fnz = jnp.where(state.fnz_flag, state.l_fnz, state.l_fnz + 1)
            return state._replace(l_fnz=l_fnz.astype(jnp.int32)), \
                jnp.zeros((m21,), dtype)

        def run(op):
            state, ya2, l = op
            return processed(state, ya2, l)

        return lax.cond(process, run, skip, (state, ya2, l))

    return step


def init_imcra_state(p: ImcraParams, dtype=jnp.float32) -> ImcraState:
    m21 = p.m21
    z = jnp.zeros((m21,), dtype)
    return ImcraState(
        lambda_d=z, eta_2term=jnp.ones((m21,), dtype), xi=z,
        xi_frame=jnp.asarray(0.0, dtype), xi_m_db=jnp.asarray(0.0, dtype),
        s=z, st=z, smin=z, smint=z, smact=z, smactt=z,
        sw=jnp.zeros((m21, p.nwin), dtype),
        swt=jnp.zeros((m21, p.nwin), dtype),
        lambda_dav=z, lambda_dav_long=z, sy=z,
        l_mod_lswitch=jnp.asarray(0, jnp.int32),
        l_fnz=jnp.asarray(1, jnp.int32), fnz_flag=jnp.asarray(False))


class OmlsaEnhancer:
    """Jitted single-utterance / batched OM-LSA enhancement."""

    def __init__(self, params: ImcraParams | None = None, dtype=jnp.float32):
        self.p = params or ImcraParams()
        self.dtype = dtype
        p = self.p
        win_a, win_s = imcra_windows(p)
        win_a = jnp.asarray(win_a, dtype)
        win_s = jnp.asarray(win_s, dtype)
        step = make_imcra_step(p, dtype)
        m21 = p.m21

        @jax.jit
        def run(frames):
            t = frames.shape[0]
            spec = jnp.fft.fft(frames * win_a[None, :], axis=-1)[:, :m21]
            ya2 = jnp.abs(spec) ** 2
            ls = jnp.arange(1, t + 1, dtype=jnp.int32)
            first_nz = jnp.abs(frames[:, 0]) > p.zero_thres
            any_nz = jnp.any(jnp.abs(frames) > p.zero_thres, axis=1)
            _, gains = lax.scan(step, init_imcra_state(p, dtype),
                                (ya2, ls, first_nz, any_nz))
            mask = jnp.zeros((m21,), dtype).at[3: m21 - 1].set(1.0)
            xspec = gains * mask[None, :] * spec
            x = jnp.fft.irfft(xspec, n=p.m, axis=-1) * win_s[None, :]
            # overlap-add at hop Mno
            mno = p.mno
            ratio = p.m // mno
            chunks = x.reshape(t, ratio, mno)
            out = jnp.zeros((t + ratio - 1, mno), dtype)
            for c in range(ratio):
                out = out.at[c: c + t].add(chunks[:, c, :])
            return out.reshape(-1)

        self._run = run
        self._run_batch = jax.jit(jax.vmap(run))

        # samples-in / int16-out batched entry: raw samples upload, in-graph
        # framing (window M=512, hop Mno=128 -> the frame matrix carries
        # every sample 4x), and MATLAB fwrite-int16 rounding on device.
        # Neither the 4x-redundant frames nor float waveforms cross the
        # host<->device link.  Frames at l >= t_valid are zeroed:
        # they hit the first-nonzero silence gate (proc_IMCRA.m:145) and
        # synthesize zeros, so state and the OLA tail are bit-equal to the
        # host frames_for path (gated by test_imcra test_batch_matches_single
        # at x64).
        def run_samples(smp, t_valid):
            smp = smp.astype(dtype)   # int16 wire format -> compute dtype
            t_bucket = (smp.shape[-1] - p.mo) // p.mno
            idx = (jnp.arange(p.m)[None, :]
                   + p.mno * jnp.arange(t_bucket)[:, None])
            frames = smp[idx]
            mask = jnp.arange(t_bucket)[:, None] < t_valid
            y = run(frames * mask.astype(frames.dtype))
            return y, matlab_int16_write_jax(y)

        self._run_batch_samples = jax.jit(jax.vmap(run_samples))

    frame_bucket = 64   # all-zero padding frames hit the first-nonzero /
    #                     silence gate (proc_IMCRA.m:145), so bucketing is
    #                     inert by construction — state and outputs untouched

    def frames_for(self, x: np.ndarray) -> np.ndarray:
        p = self.p
        x = np.asarray(x, np.float64).reshape(-1)
        t = max((len(x) - p.mo) // p.mno, 0)
        idx = np.arange(p.m)[None, :] + p.mno * np.arange(t)[:, None]
        return x[idx]

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        """int16-scale samples -> enhanced stream (Nframes*Mno + Mo long,
        matching the reference's emitted raw int16 stream)."""
        frames = self.frames_for(x)
        t = frames.shape[0]
        t_pad = -(-max(t, 1) // self.frame_bucket) * self.frame_bucket
        if t_pad != t:
            frames = np.concatenate(
                [frames, np.zeros((t_pad - t, self.p.m))], axis=0)
        y = np.asarray(self._run(jnp.asarray(frames, self.dtype)))
        y = y[: t * self.p.mno + self.p.mo]
        return matlab_int16_write(y) if quantize else y

    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Batch enhancement: uploads RAW SAMPLES (framing in-graph) and
        fetches int16 PCM (int16-write rounding in-graph) — ~4x less up and
        4-8x less down than the frame-matrix/float-waveform path.  Outputs
        are bit-identical to per-utterance ``enhance`` (x64-gated).

        ``micro_batch``: chunked dispatch with in-order fetch (double
        buffering, as stream/pipeline.enhance_batch); value-identical by lane
        independence (x64-gated)."""
        p = self.p
        ts_all = np.asarray(
            [max((len(np.asarray(x).reshape(-1)) - p.mo) // p.mno, 0)
             for x in xs], np.int64)
        t_max = -(-max(int(ts_all.max()), 1) // self.frame_bucket) \
            * self.frame_bucket
        width = t_max * p.mno + p.mo
        np_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))

        def dispatch(lo: int):
            hi = min(lo + mb, len(xs))
            smp = np.zeros((mb, width), np.float64)
            ts = np.zeros((mb,), np.int64)
            ts[: hi - lo] = ts_all[lo: hi]
            for j in range(hi - lo):
                x = np.asarray(xs[lo + j], np.float64).reshape(-1)
                n_keep = int(ts[j]) * p.mno + p.mo  # frames_for's last idx+1
                smp[j, : min(n_keep, len(x))] = x[:n_keep]
            return self._run_batch_samples(
                jnp.asarray(pack_samples_for_upload(smp, np_dt)),
                jnp.asarray(ts, jnp.int32))

        pending = [dispatch(lo) for lo in range(0, len(xs), mb)]
        outs = []
        for ci, (ys, pcm) in enumerate(pending):
            fetched = np.asarray(pcm if quantize else ys)
            # copies: views would pin the whole padded chunk buffer for as
            # long as any single output lives
            for j in range(min(mb, len(xs) - ci * mb)):
                outs.append(
                    fetched[j, : int(ts_all[ci * mb + j]) * p.mno
                            + p.mo].copy())
        return outs
