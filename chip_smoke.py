"""Run the enhancement path once on the GPU and check what comes out.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Everything runs at the widths of the deployed CHiME configuration
(``default_config()``: 16 kHz, 640-sample frames, 160-sample hop, 1024-point
FFT -> F = 513 bins, dictionaries r = 100 + 100, f32) in this one process,
which owns the card.  Inputs are made from ``--seed``
(``runtime/synth.py``); nothing is read from outside the checkout, and the
generated files live under ``<checkout>/.chip_smoke/``.

Phases, one JSON line each:
  device   the card, its power limit, and which matmul precisions of an f32
           (513x200)x(200xN) product run in TF32;
  train    ``python -m se_snmf_nat_tpu train`` on seeded speech and noise;
  enhance  ``BatchRunner`` over 64 seeded clips with the headline block plan,
           checked against the same plan at x64 on the CPU backend, and one
           ``enhance`` CLI call on a single clip;
  exact    the exact scan plan against the float64 NumPy oracle, at the
           default matmul precision and at HIGHEST;
  serve    ``EnhanceServer`` with three client threads against solo
           ``StreamingSession`` runs, gated at HIGHEST and printed at the
           default precision;
  pmwf     ``enhance --algorithm pmwf`` and ``PmwfStreamingSession`` on a
           seeded 6-channel scene, and the covariance window sum's smallest
           eigenvalue at TF32 and fp32;
  timings  the phasor-matmul DFT against ``jnp.fft`` (cuFFT), and the
           batched H-solve at the bench shape.
With ``--four-cards``: the block plan's batch sharded over a 4-card 'data'
mesh, the psum training step and time sharding, each against its one-card
run.

Every phase line carries ``card``: the card's name and power limit as
``nvidia-smi`` reports them.  Any failure raises: the script exits non-zero
and prints no ``ok`` line.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parent
WORK = CHECKOUT / ".chip_smoke"

# tolerances, each with its reason
CORR_GATE = 0.99        # the repo's golden-wav gate (tests/test_oracle.py)
PREFIX_SAMPLES = 5500   # ~0.34 s before the first refit (test_oracle.py)
PREFIX_LSB = 16         # the oracle-vs-golden prefix bound (test_oracle.py)
SERVE_LSB = 4           # fleet vs solo prefix at HIGHEST: int16 rounding
PMWF_GAIN_DB = 10.0     # offline PMWF gate (test_multichannel_streaming.py)
PMWF_STREAM_GAIN_DB = 7.0   # streaming PMWF gate (same test)
TRAIN_STEP_RTOL = 1e-4  # fp32 psum order over 20 HIGHEST-precision MU steps
TIME_SHARD_CORR = 0.98  # halo warm-up with adaptation on (test_time_shard.py)
TF32_REL_ERR = 1e-5     # fp32 keeps ~1e-7 over K=200; TF32 ~1e-4


CARD = ""                # "name, power limit" from nvidia-smi, set in main


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def corr(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    return float(np.corrcoef(np.asarray(a[:n], np.float64),
                             np.asarray(b[:n], np.float64))[0, 1])


def max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    return int(np.abs(np.asarray(a[:n], np.int64)
                      - np.asarray(b[:n], np.int64)).max())


def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))


def median_seconds(fn, *args, reps: int = 10) -> float:
    """Median wall time of ``fn(*args)`` to completion, after a warm call."""
    import jax
    jax.block_until_ready(fn(*args))
    laps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        laps.append(time.perf_counter() - t0)
    return float(np.median(laps))


# --------------------------------------------------------------------------
def phase_device(n_cols: int = 8192) -> dict:
    """Which precisions of an f32 product run in TF32 on this card."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from se_snmf_nat_tpu.runtime.hardware import peaks

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    a = rng.random((513, 200)).astype(np.float32)
    b = rng.random((200, n_cols)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    rel = {}
    for name, prec in (("default", lax.Precision.DEFAULT),
                       ("high", lax.Precision.HIGH),
                       ("highest", lax.Precision.HIGHEST)):
        got = np.asarray(jax.jit(lambda x, y, p=prec: jnp.matmul(
            x, y, precision=p))(jnp.asarray(a), jnp.asarray(b)), np.float64)
        rel[name] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    tf32 = {k: v > TF32_REL_ERR for k, v in rel.items()}
    check(rel["highest"] < TF32_REL_ERR, f"HIGHEST is not fp32: {rel}")
    out = {"kind": dev.device_kind, "count": len(jax.devices()),
           "jax": jax.__version__, "matmul_rel_err_vs_f64": rel,
           "tf32": tf32, "peaks": peaks(dev.device_kind)}
    emit("device", **out)
    return out


def _write(path: Path, x: np.ndarray, fs: int = 16000) -> None:
    from se_snmf_nat_tpu.io.wavio import write_wav_int16
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav_int16(path, np.asarray(x, np.int16), fs)


def phase_train(seed: int, seconds: float = 24.0, n_files: int = 6):
    """Train rank-100 speech and noise dictionaries through the CLI."""
    from se_snmf_nat_tpu.cli import main as cli_main
    from se_snmf_nat_tpu.io.basis import load_basis
    from se_snmf_nat_tpu.runtime.grid import NOISE_TYPES, synth_noise
    from se_snmf_nat_tpu.runtime.synth import synth_speech

    fs = 16000
    rng = np.random.default_rng(seed)
    n = int(seconds / n_files * fs)
    for i in range(n_files):
        sp = synth_speech(n, fs, rng)
        _write(WORK / "train" / "speech" / f"s{i:02d}.wav",
               np.clip(np.rint(sp), -32768, 32767))
        kind = NOISE_TYPES[i % len(NOISE_TYPES)]
        nz = synth_noise(kind, n, fs, rng, speech=sp) * 2000.0
        _write(WORK / "train" / "noise" / f"n{i:02d}.wav",
               np.clip(np.rint(nz), -32768, 32767))
    bases, walls = {}, {}
    for cls in ("speech", "noise"):
        t0 = time.perf_counter()
        rc = cli_main(["train", "--db", str(WORK / "train" / cls),
                       "--basis-dir", str(WORK / "basis" / cls),
                       "--rank", "100", "--seed", str(seed), "--force"])
        walls[cls] = time.perf_counter() - t0
        check(rc == 0, f"train {cls} rc {rc}")
        pair = load_basis(WORK / "basis" / cls / "R_100.npz")
        check(pair.b_dft.shape == (513, 100), f"{cls} {pair.b_dft.shape}")
        check(bool(np.isfinite(pair.b_dft).all()
                   and (pair.b_dft >= 0).all()), f"{cls} basis not >= 0")
        bases[cls] = pair
    emit("train", seed=seed, seconds_of_audio_per_class=seconds,
         wall_s=walls, b_dft_shape=[513, 100],
         b_dft_sum={k: float(v.b_dft.astype(np.float64).sum())
                    for k, v in bases.items()})
    return bases["speech"], bases["noise"]


def phase_enhance(seed: int, speech, noise, n_clips: int = 64,
                  min_s: float = 4.0, max_s: float = 8.0,
                  batch: int = 64) -> list[np.ndarray]:
    """The shipped block plan over a directory, checked against x64."""
    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.cli import main as cli_main
    from se_snmf_nat_tpu.headline import HEADLINE_PLAN, build_headline_enhancer
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    from se_snmf_nat_tpu.runtime.runner import BatchRunner
    from se_snmf_nat_tpu.runtime.synth import noisy_clips

    clips = noisy_clips(seed, n_clips, min_s, max_s)
    d_in, d_out = WORK / "enhance" / "in", WORK / "enhance" / "out"
    for i, x in enumerate(clips):
        _write(d_in / f"c{i:03d}.wav", x)
    enh = build_headline_enhancer(bases=(speech, noise))
    walls = []
    for _ in range(2):                  # cold (compiles), then warm
        runner = BatchRunner(enh, carry_state=False, force_rewrite=True,
                             verbose=False)
        rep = runner.run(d_in, d_out, batch_size=batch)
        walls.append(rep.seconds_wall)
        check(len(rep.processed) == n_clips, "BatchRunner skipped files")
    outs = []
    for i, x in enumerate(clips):
        y, fs = read_wav_int16(d_out / f"c{i:03d}_enh.wav")
        check(fs == 16000, "output rate")
        check(len(y) == (len(x) // 160 + 1) * 160, f"clip {i} length")
        check(rms(y) < rms(x), f"clip {i}: output RMS not below input")
        outs.append(y.astype(np.int16))

    # the same plan at x64 on the CPU backend, two lanes
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        enh64 = build_headline_enhancer(bases=(speech, noise),
                                        dtype=jnp.float64)
        ref64 = enh64.enhance_batch([np.asarray(c, np.float64)
                                     for c in clips[:2]])
    x64 = {"corr": [corr(outs[i], ref64[i]) for i in range(2)],
           "max_abs_lsb": [max_lsb(outs[i], ref64[i]) for i in range(2)]}

    # the CLI on one clip (exact plan, the CLI's default)
    one_in, one_out = WORK / "enhance" / "one.wav", WORK / "enhance" / "one_enh.wav"
    _write(one_in, clips[0])
    rc = cli_main(["enhance", str(one_in), "-o", str(one_out),
                   "--speech-basis", str(WORK / "basis" / "speech" / "R_100.npz"),
                   "--noise-basis", str(WORK / "basis" / "noise" / "R_100.npz")])
    check(rc == 0, f"cli enhance rc {rc}")
    y1, _ = read_wav_int16(one_out)
    audio_s = sum(len(x) for x in clips) / 16000
    emit("enhance", plan=HEADLINE_PLAN, batch=batch, clips=n_clips,
         audio_s=audio_s, wall_s_cold=walls[0], wall_s_warm=walls[1],
         audio_s_per_s_warm=audio_s / walls[1],
         vs_x64_cpu=x64, gate=f"corr >= {CORR_GATE}",
         cli_exact_corr_vs_block=corr(y1, outs[0]))
    check(min(x64["corr"]) >= CORR_GATE, f"block plan vs x64 {x64}")
    check(len(y1) == len(outs[0]) and rms(y1) < rms(clips[0]),
          "cli enhance output")
    return clips


def phase_exact(seed: int, speech, noise, seconds: float = 2.0) -> None:
    """The exact scan plan (reference semantics) against the NumPy oracle."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.oracle.runner_np import enhance_samples_oracle
    from se_snmf_nat_tpu.runtime.synth import noisy_clip
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer

    x, _ = noisy_clip(np.random.default_rng(seed + 1), seconds)
    x = x.astype(np.float64)
    cfg = default_config()
    sb, nb = speech.b_dft, noise.b_dft
    want = enhance_samples_oracle(x, cfg, sb, nb, sb, nb)
    rows = {}
    for prec in ("default", "highest"):
        c = cfg.evolve(runtime=replace(cfg.runtime, matmul_precision=prec))
        with jax.default_matmul_precision(prec):
            got = SnmfEnhancer(c, sb, nb, sb, nb,
                               dtype=jnp.float32).enhance(x)
        check(len(got) == len(want), "exact plan length")
        rows[prec] = {"corr": corr(got, want),
                      "prefix_max_abs_lsb": max_lsb(got[:PREFIX_SAMPLES],
                                                    want[:PREFIX_SAMPLES]),
                      "max_abs_lsb": max_lsb(got, want)}
    emit("exact", seconds=seconds, vs_oracle_f64=rows,
         gate=f"prefix[:{PREFIX_SAMPLES}] <= {PREFIX_LSB} LSB, "
              f"corr >= {CORR_GATE}")
    for prec, r in rows.items():
        check(r["corr"] >= CORR_GATE and r["prefix_max_abs_lsb"] <= PREFIX_LSB,
              f"exact plan ({prec}) vs oracle {r}")


def _client(port: int, x: np.ndarray) -> np.ndarray:
    """One blocking socket client: stream the clip, read the enhanced one."""
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        f = s.makefile("rb")
        header = json.loads(f.readline())
        check("lane" in header, f"server refused: {header}")
        s.sendall(np.asarray(x, "<i2").tobytes())
        s.shutdown(socket.SHUT_WR)
        return np.frombuffer(f.read(), "<i2").astype(np.int16)


def phase_serve(seed: int, speech, noise, n_clients: int = 3,
                seconds: float = 3.0, lanes: int = 4, block: int = 8) -> None:
    """EnhanceServer under client threads against solo sessions.

    Gated at HIGHEST, where the fleet's batched and the session's
    single-lane fp32 GEMMs differ only in summation order: before the
    first refit each client must match its solo session to int16 rounding,
    which a lane that reads another lane's audio or state cannot, and the
    whole clip keeps the golden corr gate.  Past the first refit the
    adaptation's threshold tests can turn on a summation-order difference
    (on the CPU backend a client with seeded dictionaries ends 145 LSB from
    its solo session), so the whole-clip LSB is printed, not gated.  The
    shipped default precision (TF32) is printed beside it, ungated."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.runtime.server import EnhanceServer
    from se_snmf_nat_tpu.runtime.synth import noisy_clips
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu.stream.streaming import StreamingSession

    clips = noisy_clips(seed + 2, n_clients, seconds, seconds)
    sb, nb = speech.b_dft, noise.b_dft

    def serve_vs_solo(prec: str):
        cfg = default_config()
        cfg = cfg.evolve(runtime=replace(cfg.runtime, matmul_precision=prec))
        enh = SnmfEnhancer(cfg, sb, nb, sb, nb, dtype=jnp.float32)

        async def run():
            srv = await EnhanceServer(enh, n_lanes=lanes,
                                      block_frames=block).start()
            try:
                return await asyncio.gather(*[
                    asyncio.to_thread(_client, srv.port, x) for x in clips])
            finally:
                await srv.stop()

        with jax.default_matmul_precision(prec):
            t0 = time.perf_counter()
            got = asyncio.run(run())
            wall = time.perf_counter() - t0
            rows = []
            for x, y in zip(clips, got):
                sess = StreamingSession(enh, block_frames=block)
                want = np.concatenate([sess.push(x.astype(np.float64)),
                                       sess.flush()]).astype(np.int16)
                check(len(y) == len(want),
                      f"serve length {len(y)} != {len(want)}")
                rows.append({"corr": corr(y, want),
                             "prefix_max_abs_lsb": max_lsb(
                                 y[:PREFIX_SAMPLES], want[:PREFIX_SAMPLES]),
                             "max_abs_lsb": max_lsb(y, want)})
        return {"wall_s": wall, "vs_solo_session": rows}

    gated = serve_vs_solo("highest")
    shipped = serve_vs_solo("default")
    emit("serve", lanes=lanes, block_frames=block, clients=n_clients,
         seconds_each=seconds, highest=gated, default_ungated=shipped,
         gate=f"at highest: prefix[:{PREFIX_SAMPLES}] <= {SERVE_LSB} LSB, "
              f"corr >= {CORR_GATE}")
    for r in gated["vs_solo_session"]:
        check(r["corr"] >= CORR_GATE
              and r["prefix_max_abs_lsb"] <= SERVE_LSB, f"serve {gated}")


def _min_eig_over_trace(x: np.ndarray, m_nbr: int, l_nbr: int) -> dict:
    """Smallest eigenvalue over trace of the PSD window sum of
    ``multichannel/streaming.window_cov``, over every bin of every full
    window, with the outer products at DEFAULT (TF32 here) and HIGHEST."""
    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.dsp.stft import stream_frames
    from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic

    s = default_config().signal
    fr = np.stack([stream_frames(ch, s.framelength, s.frameshift, n_flush=0)
                   for ch in np.asarray(x, np.float64)])      # (C, T, L)
    spec = np.fft.rfft(fr * sqrt_hann_periodic(s.framelength), s.fftlength)
    y = jnp.asarray(np.moveaxis(spec, 1, 2), jnp.complex64)    # (C, F, T)
    f = y.shape[1]
    interior = (jnp.arange(f) >= m_nbr) & (jnp.arange(f) < f - m_nbr)
    ystack = jnp.stack([jnp.where(interior[None, :, None],
                                  jnp.roll(y, -dm, axis=1), y)
                        for dm in range(-m_nbr, m_nbr + 1)])  # (M, C, F, T)
    out = {}
    for name, prec in (("default", jax.lax.Precision.DEFAULT),
                       ("highest", jax.lax.Precision.HIGHEST)):
        r = jax.jit(lambda a, p=prec: jnp.einsum(
            "mcft,mdft->tfcd", a, jnp.conj(a), precision=p))(ystack)
        r = np.asarray(r, np.complex128)
        n_win = r.shape[0] - 2 * l_nbr
        win = sum(r[k:k + n_win] for k in range(2 * l_nbr + 1))
        win = (win + np.conj(np.swapaxes(win, -1, -2))) / 2
        eig = np.linalg.eigvalsh(win)
        tr = np.trace(win, axis1=-2, axis2=-1).real
        live = tr > 0
        out[name] = float((eig[..., 0][live] / tr[live]).min())
    return out


def phase_pmwf(seed: int, n: int = 24000) -> None:
    """The 6-channel beamformer: offline through the CLI, and streaming."""
    import jax.numpy as jnp

    from se_snmf_nat_tpu.cli import main as cli_main
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    from se_snmf_nat_tpu.multichannel.fixture import (segsnr_vs_source,
                                                      synth_mixture)
    from se_snmf_nat_tpu.multichannel.pmwf import PmwfEnhancer, PmwfParams
    from se_snmf_nat_tpu.multichannel.streaming import PmwfStreamingSession

    x, src = synth_mixture(n=n, n_ch=6, seed=seed)
    path_in, path_out = WORK / "pmwf" / "in.wav", WORK / "pmwf" / "out.wav"
    _write(path_in, np.rint(x))
    rc = cli_main(["enhance", str(path_in), "--algorithm", "pmwf",
                   "-o", str(path_out)])
    check(rc == 0, f"cli pmwf rc {rc}")
    y, _ = read_wav_int16(path_out)
    y = np.atleast_2d(y)
    floats = PmwfEnhancer(dtype=jnp.float32).enhance(x, quantize=False)
    check(bool(np.isfinite(floats).all()), "PMWF output has NaN/inf")

    sess = PmwfStreamingSession(n_ch=x.shape[0], block_frames=8,
                                dtype=jnp.float32)
    hop = 1600                                  # 100 ms pushes
    ys = [sess.push(x[:, i:i + hop], quantize=False)
          for i in range(0, x.shape[1], hop)]
    ys = np.concatenate(ys + [sess.flush(quantize=False)], axis=1)
    check(bool(np.isfinite(ys).all()), "streaming PMWF output has NaN/inf")

    # perfectly coherent channels (rolled copies of one): the case that
    # left a reduced-precision covariance indefinite
    coh = np.stack([np.roll(x[0], 977 + 31 * c) for c in range(x.shape[0])])
    y_coh = PmwfEnhancer(dtype=jnp.float32).enhance(coh, quantize=False)
    check(bool(np.isfinite(y_coh).all()), "coherent PMWF output has NaN/inf")

    p = PmwfParams()
    seg_in = max(segsnr_vs_source(x[j], src) for j in range(x.shape[0]))
    seg_out = segsnr_vs_source(y[0], src)
    seg_str = segsnr_vs_source(ys[0], src)
    emit("pmwf", channels=int(x.shape[0]), seg_snr_in_db=seg_in,
         seg_snr_out_db=seg_out, gain_db=seg_out - seg_in,
         streaming_seg_snr_out_db=seg_str, streaming_gain_db=seg_str - seg_in,
         cov_min_eig_over_trace={
             "scene": _min_eig_over_trace(x, p.m_nbr, p.l_nbr),
             "coherent": _min_eig_over_trace(coh, p.m_nbr, p.l_nbr)},
         gate=f"offline gain >= {PMWF_GAIN_DB} dB, streaming gain >= "
              f"{PMWF_STREAM_GAIN_DB} dB, both finite")
    check(seg_out - seg_in >= PMWF_GAIN_DB,
          f"PMWF gain {seg_out - seg_in:.2f} dB")
    check(seg_str - seg_in >= PMWF_STREAM_GAIN_DB,
          f"streaming PMWF gain {seg_str - seg_in:.2f} dB")


def phase_timings(clips, speech, noise, tf32_default: bool,
                  kind: str) -> None:
    """Phasor-matmul DFT vs cuFFT, and the H-solve at the bench shape."""
    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.dsp.stft import (analysis_frames, stream_frames,
                                          synthesis_frames)
    from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
    from se_snmf_nat_tpu.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_h_solve_columns
    from se_snmf_nat_tpu.runtime.hardware import peaks

    cfg = default_config()
    s = cfg.signal
    frames = np.concatenate([stream_frames(np.asarray(x, np.float64),
                                           s.framelength, s.frameshift,
                                           n_flush=cfg.delay + 1)
                             for x in clips])
    fr = jnp.asarray(frames, jnp.float32)
    win = jnp.asarray(sqrt_hann_periodic(s.framelength), jnp.float32)

    def roundtrip(matmul):
        pa = HEADLINE_PLAN["dft_precision"] if matmul else None
        ps = HEADLINE_PLAN["idft_precision"] if matmul else None

        @jax.jit
        def ana(f):
            return analysis_frames(f, win, s.fftlength, s.pow, s.dc_bin,
                                   s.nonzerofloor, s.preemph,
                                   dft_matmul=matmul, precision=pa)

        @jax.jit
        def syn(mag, ph):
            return synthesis_frames(mag, ph, s.framelength, s.fftlength, win,
                                    s.pow, s.dc_bin_back, s.overlapscale,
                                    s.preemph, dft_matmul=matmul,
                                    precision=ps)
        mag, ph = ana(fr)
        return (median_seconds(ana, fr), median_seconds(syn, mag, ph),
                np.asarray(mag))

    a_mm, s_mm, mag_mm = roundtrip(True)
    a_fft, s_fft, mag_fft = roundtrip(False)
    live = slice(s.dc_bin, None)
    mag_rel = float(np.linalg.norm(mag_mm[:, live] - mag_fft[:, live])
                    / np.linalg.norm(mag_fft[:, live]))

    # H-solve: every frame of the batch as one column set, 22 fixed trips
    trips = HEADLINE_PLAN["block_iter_cap"]
    v = jnp.asarray(mag_fft.T)                           # (F, n)
    w = jnp.asarray(np.concatenate([speech.b_dft, noise.b_dft], axis=1),
                    jnp.float32)                         # (F, 200)
    params = SnmfParams(beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
                        max_iter=trips, conv_eps=0.0, flr=1e-9,
                        precision=cfg.runtime.matmul_precision)
    h0 = jnp.full((w.shape[1], v.shape[1]), 0.5, jnp.float32)
    t_h = median_seconds(lambda a, b, c: snmf_h_solve_columns(
        a, b, c, params).h, v, w, h0, reps=5)
    f_bins, r = w.shape
    n = v.shape[1]
    flops = trips * 2 * (2.0 * f_bins * r * n)
    bytes_min = trips * 4.0 * (f_bins * n + 2 * r * n)   # V in, H in/out
    pk = peaks(kind)
    peak = pk["tf32_flops"] if tf32_default else pk["fp32_flops"]
    t_flops, t_bytes = flops / peak, bytes_min / pk["hbm_bytes_per_s"]
    row = {"shape": f"F={f_bins} r={r} n={n} trips={trips}",
           "seconds": t_h, "tflop_s": flops / t_h / 1e12,
           "roofline_share": max(t_flops, t_bytes) / t_h,
           "bound": "compute" if t_flops > t_bytes else "hbm",
           "peak": "tf32" if tf32_default else "fp32"}
    emit("timings", frames=int(frames.shape[0]),
         dft_matmul_s={"analysis": a_mm, "synthesis": s_mm},
         jnp_fft_s={"analysis": a_fft, "synthesis": s_fft},
         mag_rel_diff_matmul_vs_fft=mag_rel, h_solve=row)


# --------------------------------------------------------------------------
def phase_four_cards(seed: int, speech, noise, n_clips: int = 64,
                     long_s: float = 40.0, train_cols: int = 8192) -> None:
    """The sharded paths on a 4-card mesh, each against its one-card run."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from se_snmf_nat_tpu.headline import build_headline_enhancer
    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.io.wavio import enhanced_quantize
    from se_snmf_nat_tpu.parallel.mesh import data_sharding, make_mesh
    from se_snmf_nat_tpu.parallel.time_shard import enhance_time_sharded
    from se_snmf_nat_tpu.parallel.train_step import (
        distributed_mu_step, make_distributed_train_step)
    from se_snmf_nat_tpu.runtime.synth import noisy_clip, noisy_clips
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = make_mesh((4, 1), devices=devs[:4])
    one = devs[0]

    # 1. block plan, B=64 sharded over 'data' (16 lanes per card)
    enh = build_headline_enhancer(bases=(speech, noise))
    clips = noisy_clips(seed, n_clips, 4.0, 8.0)
    framed = [enh.frames_for(np.asarray(x, np.float64)) for x in clips]
    t_true = np.asarray([f.shape[0] for f in framed], np.int32)
    width = -(-int(t_true.max()) // enh.frame_bucket) * enh.frame_bucket
    frames = np.stack([np.pad(f, ((0, width - f.shape[0]), (0, 0)))
                       for f in framed]).astype(np.float32)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_clips,) + a.shape),
                          enh.initial_state())
    fr4 = jax.device_put(frames, data_sharding(mesh, 3, 0))
    tv4 = jax.device_put(t_true, data_sharding(mesh, 1, 0))
    t0 = time.perf_counter()
    y4 = np.asarray(enh._block_run_batch(fr4, states, enh.win, tv4)[0])
    wall4 = time.perf_counter() - t0
    fr1 = jax.device_put(frames, one)
    y1 = np.asarray(enh._block_run_batch(fr1, states, enh.win,
                                         jax.device_put(t_true, one))[0])
    start = enh.cfg.delay * enh.cfg.signal.frameshift
    dp = []
    for i, t in enumerate(t_true):
        stop = start + (int(t) - enh.cfg.delay) * enh.cfg.signal.frameshift
        a = enhanced_quantize(y4[i, start:stop])
        b = enhanced_quantize(y1[i, start:stop])
        dp.append((corr(a, b), max_lsb(a, b)))
    dp_row = {"min_corr": min(c for c, _ in dp),
              "max_abs_lsb": max(m for _, m in dp), "wall_s_first": wall4}

    # 2. psum training step over the frame axis
    from se_snmf_nat_tpu.dsp.stft import analysis_frames, stream_frames
    s = enh.cfg.signal
    speech_x = np.concatenate([np.asarray(x, np.float64) for x in clips[:8]])
    sf = stream_frames(speech_x, s.framelength, s.frameshift, n_flush=0)
    sf = sf[:min(train_cols, len(sf) // 4 * 4)]         # 4 equal shards
    mag, _ = analysis_frames(jnp.asarray(sf, jnp.float32), enh.win,
                             s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
                             s.preemph)
    v = np.asarray(mag).T                                   # (F, T)
    rng = np.random.default_rng(seed)
    w0 = (np.abs(rng.standard_normal((v.shape[0], 100))) + 1e-3
          ).astype(np.float32)
    h0 = (np.abs(rng.standard_normal((100, v.shape[1]))) + 1e-3
          ).astype(np.float32)
    n_iter = 20
    step = make_distributed_train_step(mesh, n_iter=n_iter)
    w4, h4 = step(v, w0, h0)
    w4, h4 = np.asarray(w4), np.asarray(h4)

    @jax.jit
    def single(v, w, h):
        return jax.lax.fori_loop(0, n_iter, lambda _, wh: distributed_mu_step(
            v, *wh), (w, h))
    w1, h1 = (np.asarray(a) for a in single(*(jax.device_put(a, one)
                                               for a in (v, w0, h0))))
    tr_row = {"cols": int(v.shape[1]), "iters": n_iter,
              "w_rel_diff": float(np.linalg.norm(w4 - w1)
                                  / np.linalg.norm(w1)),
              "h_rel_diff": float(np.linalg.norm(h4 - h1)
                                  / np.linalg.norm(h1))}

    # 3. time sharding of one long utterance (every shard past its halo)
    # fp32 products (as in phase_serve): the comparison is of the halo
    # warm-up, not of TF32 rounding amplified by the adaptation gates
    x_long, _ = noisy_clip(np.random.default_rng(seed + 3), long_s)
    x_long = x_long.astype(np.float64)
    cfg = default_config()
    cfg = cfg.evolve(runtime=replace(cfg.runtime, matmul_precision="highest"))
    exact = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                         noise.b_dft, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        y_ts = enhance_time_sharded(exact, x_long, mesh)
        wall_ts = time.perf_counter() - t0
        with jax.default_device(one):
            y_seq = exact.enhance(x_long)
    ts_row = {"seconds": long_s, "frames": int(exact.frames_for(
        x_long).shape[0]), "corr": corr(y_ts, y_seq),
        "max_abs_lsb": max_lsb(y_ts, y_seq), "wall_s_first": wall_ts}
    emit("four_cards", dp_block_plan=dp_row, train_step=tr_row,
         time_shard=ts_row,
         gate=f"DP corr >= {CORR_GATE}; train rel diff <= {TRAIN_STEP_RTOL}; "
              f"time shard corr >= {TIME_SHARD_CORR}")
    check(dp_row["min_corr"] >= CORR_GATE, f"DP block plan {dp_row}")
    check(max(tr_row["w_rel_diff"], tr_row["h_rel_diff"]) <= TRAIN_STEP_RTOL,
          f"train step {tr_row}")
    check(len(y_ts) == len(y_seq) and ts_row["corr"] >= TIME_SHARD_CORR,
          f"time shard {ts_row}")


def seeded_bases(seed: int):
    """Rank-100 nonnegative dictionaries from a seed, for the four-card run
    (which compares sharded with unsharded runs and trains nothing)."""
    from se_snmf_nat_tpu.io.basis import BasisPair
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = rng.random((513, 100)) + 1e-3
        out.append(BasisPair(b_dft=b / np.linalg.norm(b, axis=0),
                             b_mel=rng.random((64, 100)) + 1e-3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 4-card sharded paths and nothing else")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from se_snmf_nat_tpu.runtime.hardware import enable_compile_cache
    enable_compile_cache()
    global CARD
    CARD = "; ".join(smi.splitlines())
    print(smi, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    if args.four_cards:
        speech, noise = seeded_bases(args.seed)
        phase_four_cards(args.seed, speech, noise)
    else:
        dev = phase_device()
        speech, noise = phase_train(args.seed)
        clips = phase_enhance(args.seed, speech, noise)
        phase_exact(args.seed, speech, noise)
        phase_serve(args.seed, speech, noise)
        phase_pmwf(args.seed)
        phase_timings(clips, speech, noise, dev["tf32"]["default"],
                      dev["kind"])
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
