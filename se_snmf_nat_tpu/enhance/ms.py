"""MS enhancement stack (Ephraim-Malah MMSE / log-MMSE gain + Rainer Martin
minimum-statistics noise tracking) — JAX scan engine.

Reference: src/MS/ssubmmse.m + src/MS/estnoisem.m (the GUI's 'MS' mode,
SE_GUI.m:420-426, with init_MS.m's ti=0.01 override).  The re-design mirrors
the other engines: batched rfft outside, one lax.scan carrying BOTH the
minimum-statistics tracker state and the decision-directed xu recurrence
(the reference runs them as two passes; fusing them is exact because the
gain of frame t only needs the tracker state after frame t), batched irfft
+ OLA after.  Chunked streaming state (input tail, OLA tail, tracker state,
xu — ssubmmse.m:95-128,202-215) is carried by MsStreamState.

The float64 oracle (oracle/ms_np.py) pins semantics; x64 tests gate this
engine against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from se_snmf_nat_tpu.dsp.stft import pack_samples_for_upload
from se_snmf_nat_tpu.oracle.ms_np import (
    MsDerived, MsgParams, MsParams, _iround, ms_derived)
from se_snmf_nat_tpu.utils.matlab_compat import (
    matlab_int16_write, matlab_int16_write_jax)
from se_snmf_nat_tpu.utils.special import (
    bessel_i0_small, bessel_i1_small, expint_e1)


class MsScanState(NamedTuple):
    p: jnp.ndarray           # (F,) smoothed power spectrum
    sn2: jnp.ndarray         # (F,) noise PSD estimate
    pb: jnp.ndarray          # (F,) smoothed periodogram
    pb2: jnp.ndarray         # (F,) smoothed periodogram^2
    pminu: jnp.ndarray       # (F,) running minimum
    actmin: jnp.ndarray      # (F,) window minimum
    actminsub: jnp.ndarray   # (F,) sub-window minimum
    actbuf: jnp.ndarray      # (nu, F) sub-window minima ring
    lminflag: jnp.ndarray    # (F,) bool
    ac: jnp.ndarray          # scalar correction factor
    subwc: jnp.ndarray       # int32 sub-window counter
    ibuf: jnp.ndarray        # int32 ring pointer (1-based like MATLAB)
    tcount: jnp.ndarray      # int32 global frame counter (t + nrcum)
    xu: jnp.ndarray          # (F,) unsmoothed prior SNR carry


@dataclass
class MsStreamState:
    """Cross-chunk state (ssubmmse.m zo struct)."""

    scan: MsScanState | None   # None until the first frame is seen
    ssv: np.ndarray            # OLA tail (ni*(of-1),)
    si: np.ndarray             # unconsumed input samples


def make_ms_step(p: MsParams, d: MsDerived, dtype=jnp.float32):
    nv, nd, nu = d.nv, d.nd, d.nu_eff
    qith = jnp.asarray(p.qith, dtype)
    nsms = jnp.asarray(d.nsms, dtype)
    a = d.a

    def step(st: MsScanState, yft):
        # ---- minimum-statistics tracker (estnoisem.m:199-247)
        acb = 1.0 / (1.0 + (jnp.sum(st.p) / jnp.sum(yft) - 1.0) ** 2)
        ac = d.aca * st.ac + (1 - d.aca) * jnp.maximum(acb, d.aca)
        ah = d.amax * ac / (1.0 + (st.p / st.sn2 - 1.0) ** 2)
        snr = jnp.sum(st.p) / jnp.sum(st.sn2)
        ah = jnp.maximum(ah, jnp.minimum(d.aminh, snr ** d.snrexp))
        pcur = ah * st.p + (1 - ah) * yft
        b = jnp.minimum(ah * ah, d.bmax)
        pb = b * st.pb + (1 - b) * pcur
        pb2 = b * st.pb2 + (1 - b) * pcur * pcur
        tcount = st.tcount + 1
        qeqi = jnp.maximum(
            jnp.minimum((pb2 - pb * pb) / (2.0 * st.sn2 * st.sn2), d.qeqimax),
            d.qeqimin / tcount.astype(dtype))
        qiav = jnp.mean(qeqi)
        bc = 1.0 + p.av * jnp.sqrt(qiav)
        bmind = 1.0 + 2.0 * (nd - 1) * (1 - d.md) / (1.0 / qeqi - 2.0 * d.md)
        bminv = 1.0 + 2.0 * (nv - 1) * (1 - d.mv) / (1.0 / qeqi - 2.0 * d.mv)
        cand = bc * pcur * bmind
        kmod = cand < st.actmin
        actmin = jnp.where(kmod, cand, st.actmin)
        actminsub = jnp.where(kmod, bc * pcur * bminv, st.actminsub)

        middle = (st.subwc > 1) & (st.subwc < nv)
        switch = st.subwc >= nv

        # middle-of-buffer branch
        lmin_mid = st.lminflag | kmod
        pminu_mid = jnp.minimum(actminsub, st.pminu)

        # buffer-switch branch (computed unconditionally, selected below)
        ibuf_new = 1 + st.ibuf % nu
        actbuf_sw = st.actbuf.at[ibuf_new - 1].set(actmin)
        pminu_sw = actbuf_sw.min(axis=0)
        nsm = nsms[jnp.argmax(qiav < qith)]
        lmin = (st.lminflag & ~kmod & (actminsub < nsm * pminu_sw)
                & (actminsub > pminu_sw))
        pminu_sw = jnp.where(lmin, actminsub, pminu_sw)
        actbuf_sw = jnp.where(lmin[None, :], pminu_sw[None, :], actbuf_sw)

        pminu = jnp.where(switch, pminu_sw,
                          jnp.where(middle, pminu_mid, st.pminu))
        sn2 = jnp.where(middle, pminu_mid, st.sn2)
        lminflag = jnp.where(switch, jnp.zeros_like(kmod),
                             jnp.where(middle, lmin_mid, st.lminflag))
        actmin = jnp.where(switch, jnp.full_like(actmin, jnp.inf), actmin)
        actbuf = jnp.where(switch, actbuf_sw, st.actbuf)
        ibuf = jnp.where(switch, ibuf_new, st.ibuf).astype(jnp.int32)
        subwc = (jnp.where(switch, 0, st.subwc) + 1).astype(jnp.int32)

        # ---- MMSE gain (ssubmmse.m:165-189); dp = sn2 after this frame
        gam = jnp.minimum(yft / sn2, p.gx)
        xi = a * st.xu + (1 - a) * jnp.maximum(gam - 1.0, p.xn)
        if p.lg:
            xir = xi / (1.0 + xi)
            arg = jnp.maximum(xir * gam, 1e-35)
            gi = xir * jnp.exp(0.5 * expint_e1(arg))
        else:
            v = 0.5 * xi * gam / (1.0 + xi)
            gam_safe = jnp.maximum(gam, 1e-35)
            gi_hi = (0.277 + 2.0 * v) / gam_safe
            kk = np.sqrt(2.0 * np.pi)
            gi_lo = kk * jnp.sqrt(v) * ((0.5 + v) * bessel_i0_small(v)
                                        + v * bessel_i1_small(v)) \
                / (gam_safe * jnp.exp(v))
            gi = jnp.where(v < 0.5, gi_lo, gi_hi)
        xu = gam * gi * gi

        new = MsScanState(p=pcur, sn2=sn2, pb=pb, pb2=pb2, pminu=pminu,
                          actmin=actmin, actminsub=actminsub, actbuf=actbuf,
                          lminflag=lminflag, ac=ac, subwc=subwc, ibuf=ibuf,
                          tcount=tcount, xu=xu)
        return new, gi

    return step


def init_ms_scan_state(yp0: jnp.ndarray, p: MsParams, d: MsDerived,
                       dtype=jnp.float32) -> MsScanState:
    """First-frame initialization (estnoisem.m:186-198) + xu=1
    (ssubmmse.m:160)."""
    f = yp0.shape[0]
    inf = jnp.full((f,), jnp.inf, dtype)
    return MsScanState(
        p=yp0, sn2=yp0, pb=yp0, pb2=yp0 * yp0, pminu=yp0,
        actmin=inf, actminsub=inf,
        actbuf=jnp.full((d.nu_eff, f), jnp.inf, dtype),
        lminflag=jnp.zeros((f,), bool),
        ac=jnp.asarray(1.0, dtype), subwc=jnp.asarray(d.nv, jnp.int32),
        ibuf=jnp.asarray(0, jnp.int32), tcount=jnp.asarray(0, jnp.int32),
        xu=jnp.ones((f,), dtype))


class MsgScanState(NamedTuple):
    """MMSE-SPP tracker carry (estnoiseg.m rebuild) + the gain's xu."""

    xt: jnp.ndarray      # (F,) noise PSD estimate
    pslp: jnp.ndarray    # (F,) smoothed speech-presence probability
    xu: jnp.ndarray      # (F,) unsmoothed prior SNR carry


def make_msg_step(p: MsParams, g: MsgParams, d: MsDerived, dtype=jnp.float32):
    """Fused MMSE-SPP noise tracking (estnoiseg.m:120-137; the reference
    ships this tracker caller-less — here it is a selectable alternative to
    minimum statistics) + the same MMSE gain chain."""
    tinc = d.tinc
    ax = np.exp(-tinc / g.tax)
    ap = np.exp(-tinc / g.tap)
    xih1 = 10.0 ** (g.asnr / 10.0)
    xih1r = 1.0 / (1.0 + xih1) - 1.0
    pfac = (1.0 / g.pspri - 1.0) * (1.0 + xih1)
    a = d.a

    def step(st: MsgScanState, yft):
        ph1y = 1.0 / (1.0 + pfac * jnp.exp(xih1r * yft / st.xt))
        pslp = ap * st.pslp + (1 - ap) * ph1y
        ph1y = jnp.minimum(ph1y, 1.0 - g.pnsaf * (pslp > g.psthr))
        xtr = (1.0 - ph1y) * yft + ph1y * st.xt
        xt = ax * st.xt + (1 - ax) * xtr

        gam = jnp.minimum(yft / xt, p.gx)
        xi = a * st.xu + (1 - a) * jnp.maximum(gam - 1.0, p.xn)
        xir = xi / (1.0 + xi)
        arg = jnp.maximum(xir * gam, 1e-35)
        gi = xir * jnp.exp(0.5 * expint_e1(arg))
        xu = gam * gi * gi
        return MsgScanState(xt=xt, pslp=pslp, xu=xu), gi

    return step


class MmseEnhancer:
    """Chunk-capable MMSE/log-MMSE enhancer (the reference GUI's MS mode).

    tracker: 'martin' (minimum statistics, estnoisem — the reference's live
    choice) or 'mmse' (MMSE-SPP, estnoiseg).
    """

    def __init__(self, fs: int = 16000, params: MsParams | None = None,
                 dtype=jnp.float32, tracker: str = "martin",
                 msg_params: MsgParams | None = None):
        self.p = params or MsParams()
        self.fs = fs
        self.d = ms_derived(self.p, fs)
        self.dtype = dtype
        self.tracker = tracker
        self.g = msg_params or MsgParams()
        d, p = self.d, self.p
        win = jnp.asarray(d.win, dtype)
        if tracker == "mmse":
            step = make_msg_step(p, self.g, d, dtype)
        else:
            step = make_ms_step(p, d, dtype)
        ni, nf = d.ni, d.nf
        no = _iround(p.of)

        @jax.jit
        def run(frames, state0, n_valid):
            # frames are bucket-padded with zeros; padded frames contribute
            # zero to the OLA (zero input -> zero synthesis) and the masked
            # step keeps them out of the tracker state
            y = frames * win[None, :]
            yf = jnp.fft.rfft(y, nf, axis=1)
            yp = (yf * jnp.conj(yf)).real.astype(dtype)
            t = frames.shape[0]
            idx = jnp.arange(t, dtype=jnp.int32)

            def masked(st, xs):
                yp_t, i = xs
                new_st, g = step(st, yp_t)
                ok = i < n_valid
                st_out = jax.tree.map(lambda a, b: jnp.where(ok, a, b),
                                      new_st, st)
                return st_out, jnp.where(ok, g, jnp.zeros_like(g))

            state, gains = lax.scan(masked, state0, (yp, idx))
            se = jnp.fft.irfft(yf * gains, nf, axis=1).astype(dtype) \
                * win[None, :]
            ratio = nf // ni
            chunks = se.reshape(t, ratio, ni)
            out = jnp.zeros((t + ratio - 1, ni), dtype)
            for c in range(ratio):
                out = out.at[c: c + t].add(chunks[:, c, :])
            return out.reshape(-1), state

        self._run = run
        self._no = no
        self.frame_bucket = 64

        # samples-in / int16-out batched entry (one-shot semantics): raw
        # samples upload, in-graph framing (window nf, hop ni -> 2x frame
        # redundancy), MATLAB fwrite-int16 rounding on device.
        # Frames at l >= n_valid need no masking: the masked scan zeroes
        # their gains, so they synthesize zeros and add nothing to the OLA
        # — bit-equal to the host framing path (x64-gated in test_ms).
        def run_samples(smp, scan0, n_valid):
            smp = smp.astype(dtype)   # int16 wire format -> compute dtype
            nr_b = (smp.shape[-1] - (nf - ni)) // ni
            idx = (ni * jnp.arange(nr_b)[:, None]
                   + jnp.arange(nf)[None, :])
            y, _ = run(smp[idx], scan0, n_valid)
            return y, matlab_int16_write_jax(y)

        self._run_batch_samples = jax.jit(jax.vmap(run_samples))

    def _scan0(self, s: np.ndarray, idx: np.ndarray, nr: int):
        """First-chunk tracker init, on host in float64 so every execution
        plan (single, chunked, batched) starts from bit-identical state."""
        d, nf = self.d, self.d.nf
        win = d.win
        if self.tracker == "mmse":
            # estnoiseg.m:122-124 init: psini * mean of the first
            # ~tavini seconds of frames
            n0 = max(1, min(nr, _iround(1 + self.g.tavini / d.tinc)))
            y0 = np.fft.rfft(s[idx[:n0]] * win[None, :], nf, axis=1)
            yp0 = (y0 * np.conj(y0)).real
            return MsgScanState(
                xt=jnp.asarray(self.g.psini * yp0.mean(axis=0), self.dtype),
                pslp=jnp.full((nf // 2 + 1,), self.g.psini, self.dtype),
                xu=jnp.ones((nf // 2 + 1,), self.dtype))
        y0 = np.fft.rfft(s[idx[0]] * win, nf)
        yp0 = jnp.asarray((y0 * np.conj(y0)).real, self.dtype)
        return init_ms_scan_state(yp0, self.p, d, self.dtype)

    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Batch one-shot enhancement (the BatchRunner's DP plan for MS —
        the runner never threads MS stream state across files, runner.py).

        Uploads RAW SAMPLES and fetches int16 PCM; the tracker init runs on
        host per utterance (cheap: one float64 rfft) so batched outputs are
        bit-identical to per-utterance ``enhance`` (x64-gated in test_ms).

        ``micro_batch``: chunked dispatch with in-order fetch (double
        buffering), as stream/pipeline.enhance_batch — overlapping chunk
        n+1's upload with chunk n's download.  Value-identical
        (lane independence; x64-gated)."""
        d = self.d
        ni, nf = d.ni, d.nf
        xs_np = [np.asarray(x, np.float64).reshape(-1) for x in xs]
        nrs_all = np.asarray(
            [(len(x) - nf + ni) // ni if len(x) >= nf else 0 for x in xs_np],
            np.int64)
        if int(nrs_all.max()) == 0:
            return [np.zeros(0, np.int16 if quantize else np.float64)
                    for _ in xs]
        nr_max = -(-int(nrs_all.max()) // self.frame_bucket) \
            * self.frame_bucket
        width = ni * (nr_max - 1) + nf
        np_dt = np.float64 if self.dtype == jnp.float64 else np.float32
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))

        def dispatch(lo: int):
            hi = min(lo + mb, len(xs))
            smp = np.zeros((mb, width), np.float64)
            nrs = np.zeros((mb,), np.int64)
            nrs[: hi - lo] = nrs_all[lo: hi]
            scan0s = []
            for j in range(mb):
                i = lo + j
                nr = int(nrs[j])
                if i >= len(xs) or nr == 0:
                    # inert placeholder lane; its outputs are discarded
                    scan0s.append(self._scan0(np.zeros(nf),
                                              np.arange(nf)[None, :], 1))
                    continue
                x = xs_np[i]
                # samples past the last frame (ni*(nr-1)+nf) are never
                # framed; drop them so a bucket-aligned longest utterance
                # with a trailing partial hop still fits the buffer width
                n_keep = min(len(x), width)
                smp[j, : n_keep] = x[:n_keep]
                idx = ni * np.arange(nr)[:, None] + np.arange(nf)[None, :]
                scan0s.append(self._scan0(x, idx, nr))
            scan0_b = jax.tree.map(lambda *a: jnp.stack(a), *scan0s)
            return self._run_batch_samples(
                jnp.asarray(pack_samples_for_upload(smp, np_dt)), scan0_b,
                jnp.asarray(nrs, jnp.int32))

        pending = [dispatch(lo) for lo in range(0, len(xs), mb)]
        outs = []
        for ci, (ys, pcm) in enumerate(pending):
            fetched = np.asarray(pcm if quantize else ys)
            for j in range(min(mb, len(xs) - ci * mb)):
                nr = int(nrs_all[ci * mb + j])
                if nr == 0:
                    outs.append(np.zeros(0, np.int16 if quantize
                                         else np.float64))
                    continue
                out = fetched[j, : ni * (nr + self._no - 1)]
                # copy: a view would pin the whole padded batch buffer
                outs.append(out.copy() if quantize
                            else out.astype(np.float64))
        return outs

    def initial_state(self) -> MsStreamState:
        return MsStreamState(scan=None,
                             ssv=np.zeros(self.d.ni * (self._no - 1)),
                             si=np.zeros(0))

    def enhance(self, x: np.ndarray, state: MsStreamState | None = None,
                return_state: bool = False, quantize: bool = True):
        """Enhance int16-scale samples.  Without state: one-shot full-stream
        output.  With state/return_state: chunked semantics matching
        ssubmmse's resume protocol."""
        d = self.d
        ni, nf = d.ni, d.nf
        chunked = state is not None or return_state
        st = state or self.initial_state()
        s = np.concatenate([st.si, np.asarray(x, np.float64).reshape(-1)])
        nr = (len(s) - nf + ni) // ni if len(s) >= nf else 0
        tail = ni * (self._no - 1)
        if nr == 0:
            # dtype follows quantize even for empty output, matching the
            # non-empty paths and enhance_batch
            out = np.zeros(0, np.int16) if quantize else np.zeros(0)
            new_state = MsStreamState(scan=st.scan, ssv=st.ssv, si=s)
            if return_state:
                return out, new_state
            return out
        idx = ni * np.arange(nr)[:, None] + np.arange(nf)[None, :]
        frames_np = s[idx]
        nr_pad = -(-nr // self.frame_bucket) * self.frame_bucket
        if nr_pad != nr:
            frames_np = np.concatenate(
                [frames_np, np.zeros((nr_pad - nr, nf))], axis=0)
        frames = jnp.asarray(frames_np, self.dtype)
        scan0 = st.scan if st.scan is not None else self._scan0(s, idx, nr)
        ss, scan_out = self._run(frames, scan0, jnp.asarray(nr, jnp.int32))
        ss = np.array(ss, np.float64, copy=True)[: ni * (nr + self._no - 1)]
        ss[:tail] += st.ssv
        if not chunked:
            return matlab_int16_write(ss) if quantize else ss
        emitted = len(ss) - tail
        new_state = MsStreamState(scan=scan_out, ssv=ss[emitted:].copy(),
                                  si=s[emitted:].copy())
        out = ss[:emitted]
        out_q = matlab_int16_write(out) if quantize else out
        if return_state:
            return out_q, new_state
        return out_q
