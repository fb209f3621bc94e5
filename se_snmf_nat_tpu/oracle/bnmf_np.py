"""Sequential NumPy float64 mirror of the BNMF online enhancer
(bnmf/enhance.py) — the x64 parity oracle.

Plain Python loops over frames and VB iterations, no JAX: gates that the
JAX pipeline's restructuring (lax.scan frame loop, lax.cond refit gate,
fixed-shape ring buffers, masked buffer statistics) is semantically a
no-op.  The VB block-update equations are deliberately re-implemented
here in plain NumPy (only the backend-generic ``digamma`` is shared) so
the oracle is an independent statement of the math as well as of the
orchestration; a change to either copy that the other doesn't mirror
fails the x64 parity gates.

Reference: /root/reference/proc_BNMF_nmoh.m (wrapper semantics; the inner
@NMF class is absent from the reference repo — see bnmf/enhance.py's
docstring for the reconstruction notes and deviations).
"""

from __future__ import annotations

import numpy as np

from se_snmf_nat_tpu.bnmf.enhance import (
    _EPS, _WADA_POLY, BnmfParams, _frame, _safe_std, _window)
from se_snmf_nat_tpu.bnmf.vb import GammaPost, init_train
from se_snmf_nat_tpu.utils.special import digamma

_FLR = 1e-30


def _explog(shape, scale):
    return np.exp(digamma(shape, xp=np)) * scale


def spectrogram_np(x: np.ndarray, p: BnmfParams) -> np.ndarray:
    frames = _frame(np.asarray(x, np.float64), p.alen, p.ulen)
    spec = np.fft.rfft(frames * _window(p.alen)[None, :], axis=1)
    return p.spec_scale * np.abs(spec).T


def vb_train_np(x, w0, h0, b0_w, b0_h, a_w=1.0, a_h=1.0, n_iter=100):
    """Mirror of vb.vb_train: alternating H/W Gamma block updates."""
    x = np.maximum(np.asarray(x, np.float64), _FLR)
    wa = np.full_like(w0, a_w)
    ws = np.asarray(w0) / a_w
    ha = np.full_like(h0, a_h)
    hs = np.asarray(h0) / a_h
    rw, rh = a_w / b0_w, a_h / b0_h
    for _ in range(n_iter):
        lw = _explog(wa, ws)
        ew_colsum = np.sum(wa * ws, 0)[:, None]
        lh = _explog(ha, hs)
        lam = np.maximum(lw @ lh, _FLR)
        sh = lh * (lw.T @ (x / lam))
        ha = np.maximum(a_h + sh, 1e-12)
        hs = np.broadcast_to(1.0 / (rh + ew_colsum), ha.shape).copy()
        lh = _explog(ha, hs)
        eh_rowsum = np.sum(ha * hs, 1)[None, :]
        lam = np.maximum(lw @ lh, _FLR)
        sw = lw * ((x / lam) @ lh.T)
        wa = np.maximum(a_w + sw, 1e-12)
        ws = np.broadcast_to(1.0 / (rw + eh_rowsum), wa.shape).copy()
    return GammaPost(wa, ws), GammaPost(ha, hs)


def _clamp_min_shape(a, s, min_shape):
    mean = a * s
    a2 = np.maximum(a, min_shape)
    return a2, mean / a2


def train_speech_model_np(speech, p: BnmfParams, seed=0):
    speech = np.asarray(speech, np.float64)
    speech = speech / _safe_std(speech)
    spect = spectrogram_np(speech, p)
    w0, h0, b0w, b0h = init_train(spect, p.k_speech, seed=seed)
    w, h = vb_train_np(spect, w0, h0, b0w, b0h, n_iter=p.train_iters)
    u0 = np.mean(h.shape * h.scale, axis=1, keepdims=True)
    return w, u0


def enhance_np(x, w_s: GammaPost, u_s0, p: BnmfParams,
               seed_noise: int = 1) -> np.ndarray:
    """Full online enhancement, sequential; returns unquantized float64
    samples (mirror of BnmfEnhancer.enhance(quantize=False))."""
    x = np.asarray(x, np.float64)
    frames_raw = _frame(x, p.alen, p.ulen)
    t = frames_raw.shape[0]
    if t == 0:
        return np.zeros(0)
    head = x[: p.init_hops * p.ulen]
    sigma = _safe_std(head)
    frames = frames_raw / sigma
    win = _window(p.alen)
    norm_coef = float(np.sqrt(np.sum(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(p.alen) / p.alen)) ** 2)))

    # ---- noise init (mirror of _train_noise_init)
    headn = head / _safe_std(head)
    nos = spectrogram_np(headn, p)
    w0, h0, b0w, b0h = init_train(nos, p.k_noise, seed=seed_noise)
    wn, hn = vb_train_np(nos, w0, h0, b0w, b0h, n_iter=p.noise_init_iters)
    wn_a, wn_s = _clamp_min_shape(wn.shape, wn.scale, p.min_noise_shape)
    u_n = np.mean(hn.shape * hn.scale, axis=1, keepdims=True)

    f = nos.shape[0]
    buf = np.zeros((f, p.buffer_len))
    bmask = np.zeros(p.buffer_len)
    ncols = min(nos.shape[1], p.buffer_len)
    buf[:, :ncols] = nos[:, -ncols:]
    bmask[:ncols] = 1.0
    bptr = ncols % p.buffer_len
    newc = 0
    ring1 = np.zeros(p.wada_win)
    ring2 = np.zeros(p.wada_win)
    rptr = 0
    snr_lt = 0.0
    u_s = u_s0.copy()

    lw_s = _explog(w_s.shape, w_s.scale)
    ew_s = w_s.shape * w_s.scale
    ews_colsum = np.sum(ew_s, 0)[:, None]
    k_s = lw_s.shape[1]
    k_n = p.k_noise
    phi = np.concatenate([np.zeros((k_s, 1)),
                          np.full((k_n, 1), p.a_noise)])
    poly = _WADA_POLY
    b0h_buf = 1.0
    out_frames = np.zeros((t, p.alen))

    for n in range(1, t + 1):
        frame = frames[n - 1]
        spec = np.fft.rfft(frame * win)
        y = np.maximum(p.spec_scale * np.abs(spec), _FLR)[:, None]

        # ---- inference (mirror of infer())
        lw_n = _explog(wn_a, wn_s)
        ew_n = wn_a * wn_s
        lw = np.concatenate([lw_s, lw_n], axis=1)
        ew = np.concatenate([ew_s, ew_n], axis=1)
        ew_colsum = np.concatenate(
            [ews_colsum, np.sum(ew_n, 0)[:, None]], axis=0)
        u = np.concatenate([u_s, u_n], axis=0)
        inv_rate = np.where(phi > 0.0, phi / np.maximum(u, _FLR), 0.0)
        ha = np.maximum(phi, 1.0)
        hs = np.maximum(u, _FLR) / np.maximum(phi, 1.0)
        for _ in range(p.n_infer):
            lh = _explog(ha, hs)
            lam = np.maximum(lw @ lh, _FLR)
            sh = lh * (lw.T @ (y / lam))
            ha = np.maximum(phi + sh, 1e-12)
            hs = 1.0 / (inv_rate + ew_colsum)
        eh = ha * hs
        lam_s = ew[:, :k_s] @ eh[:k_s]
        lam_n = ew[:, k_s:] @ eh[k_s:]
        gain = lam_s / np.maximum(lam_s + lam_n, _FLR)
        s_hat = gain * y

        sm = p.prior_smooth
        u_s = sm * u_s + (1.0 - sm) * eh[:k_s]
        u_n = sm * u_n + (1.0 - sm) * eh[k_s:]

        e_s = np.sum(s_hat ** 2)
        e_n = np.sum((y - s_hat) ** 2)
        inst = 10.0 * np.log10(max(e_s, _FLR) / max(e_n, _FLR))
        push = (n <= p.init_hops) or (inst < snr_lt)
        if push:
            buf[:, bptr] = y[:, 0]
            bmask[bptr] = 1.0
            bptr = (bptr + 1) % p.buffer_len
            newc += 1

        if newc >= p.refit_every:
            # ---- refit (mirror of _noise_refit)
            xb = np.maximum(buf, _FLR)
            a0_w = p.rho * wn_a
            r0_w = p.rho / wn_s
            hb_a = np.ones((k_n, p.buffer_len))
            hb_s = np.full((k_n, p.buffer_len), b0h_buf)
            for _ in range(p.n_refit):
                lw_b = _explog(wn_a, wn_s)
                ew_bcol = np.sum(wn_a * wn_s, 0)[:, None]
                lh_b = _explog(hb_a, hb_s)
                lam_b = np.maximum(lw_b @ lh_b, _FLR)
                sh_b = lh_b * (lw_b.T @ (xb / lam_b))
                hb_a = np.maximum(1.0 + sh_b, 1e-12)
                hb_s = np.broadcast_to(
                    1.0 / (1.0 / b0h_buf + ew_bcol), hb_a.shape).copy()
                lh_b = _explog(hb_a, hb_s) * bmask[None, :]
                eh_rowsum = np.sum(hb_a * hb_s * bmask[None, :],
                                   1)[None, :]
                lam_b = np.maximum(lw_b @ lh_b, _FLR)
                sw_b = lw_b * (((xb / lam_b) * bmask[None, :]) @ lh_b.T)
                wn_a = np.maximum(a0_w + sw_b, 1e-12)
                wn_s = 1.0 / (r0_w + eh_rowsum)
            wn_a, wn_s = _clamp_min_shape(wn_a, wn_s, p.min_noise_shape)
            newc = 0

        hop = frame[: p.ulen]
        ring1[rptr] = np.sum(np.abs(hop))
        ring2[rptr] = np.sum(np.log(np.abs(hop) + _EPS))
        rptr = (rptr + 1) % p.wada_win
        n_samp = p.wada_win * p.ulen
        g = np.log(np.sum(ring1) / n_samp) - np.sum(ring2) / n_samp
        p1, p2, p3 = poly
        disc = p2 * p2 - 4.0 * p1 * (p3 - g)
        sq = np.sqrt(max(disc, 0.0))
        r_a = (-p2 + sq) / (2.0 * p1)
        r_b = (-p2 - sq) / (2.0 * p1)
        if disc >= 0.0:
            root = r_a if abs(r_a) < abs(r_b) else r_b
        else:
            root = -p2 / (2.0 * p1)
        if n > p.wada_win:
            snr_lt = p.snr_smooth * snr_lt + (1.0 - p.snr_smooth) * root

        est = (s_hat[:, 0] / p.spec_scale) * np.exp(1j * np.angle(spec))
        est[0] = est[0].real
        est[-1] = est[-1].real
        out_frames[n - 1] = np.fft.irfft(est * norm_coef, n=p.alen)

    fh, sh_ = out_frames[:, : p.ulen], out_frames[:, p.ulen:]
    out = np.zeros((t + 1, p.ulen))
    out[:t] += fh
    out[1:] += sh_
    return out.reshape(-1) * sigma
