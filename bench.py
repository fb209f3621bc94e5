"""Headline benchmark: audio-seconds/s/chip for the full adaptive
SNMF-NAT enhancement pipeline (north-star CHiME config).

    python bench.py                      # M03 fixture + reference dictionaries
    python bench.py --seed 0 --speech-basis S.npz --noise-basis N.npz

Without arguments it reads the reference's M03 recording and pretrained
dictionaries; ``--seed`` replaces the recording with a seeded noisy clip
(``runtime/synth.py``) and ``--speech-basis``/``--noise-basis`` replace the
dictionaries (``.npz`` from ``python -m se_snmf_nat_tpu train``).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

vs_baseline is measured against the target of 100x real-time per chip
(BASELINE.md).  Utilization figures divide by the device's row of
``runtime/hardware.PEAKS``; a device without one is an error.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="headline benchmark")
    ap.add_argument("--seed", type=int, default=None,
                    help="time a seeded noisy clip instead of the M03 wav")
    ap.add_argument("--speech-basis", help="speech dictionary (.npz/.mat)")
    ap.add_argument("--noise-basis", help="noise dictionary (.npz/.mat)")
    args = ap.parse_args(argv)

    import jax

    from se_snmf_nat_tpu.runtime.hardware import enable_compile_cache, peaks
    enable_compile_cache()
    import jax.numpy as jnp

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.io.basis import (load_basis, load_reference_speech_noise,
                                          reference_wav)
    from se_snmf_nat_tpu.io.wavio import read_wav_int16

    dev = jax.devices()[0]
    peak = peaks(dev.device_kind)
    cfg = default_config()
    if bool(args.speech_basis) != bool(args.noise_basis):
        raise SystemExit("give both --speech-basis and --noise-basis")
    if args.speech_basis:
        speech = load_basis(args.speech_basis)
        noise = load_basis(args.noise_basis).tiled_to_rank(cfg.sep.r_d)
    else:
        speech, noise = load_reference_speech_noise(cfg.sep.r_d)
    if args.seed is None:
        x, fs = read_wav_int16(reference_wav("M03_423C0213_STR.CH6.wav"))
    else:
        from se_snmf_nat_tpu.runtime.synth import noisy_clip
        fs = 16000
        x = noisy_clip(np.random.default_rng(args.seed), 3.4, fs)[0]
        x = x.astype(np.float64)

    # the production throughput plan, defined once in headline.py
    from se_snmf_nat_tpu.headline import (
        HEADLINE_BATCH, HEADLINE_PLAN, build_headline_enhancer)

    enh = build_headline_enhancer(cfg, bases=(speech, noise))
    true_frames = enh.frames_for(x)
    n_true = true_frames.shape[0]
    frames = enh._pad_frames(true_frames)

    batch_size = HEADLINE_BATCH
    batch = jnp.asarray(np.stack([frames] * batch_size), jnp.float32)
    states = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch_size,) + a.shape),
        enh.initial_state())

    # true (pre-padding) frame count: bucket-padding frames run masked in
    # production, so the metric must not count them as processed audio
    t_valid = jnp.full((batch_size,), n_true, jnp.int32)

    # compile + warmup
    ys, _ = enh._block_run_batch(batch, states, enh.win, t_valid)
    jax.block_until_ready(ys)

    n_rep = 20
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_rep):
            ys, _ = enh._block_run_batch(batch, states, enh.win, t_valid)
        jax.block_until_ready(ys)
        windows.append((time.perf_counter() - t0) / n_rep)
    elapsed_single = min(windows)

    # paired dispatch: TWO B=64 batches folded into one jitted program (two
    # sequential B=64 programs in one dispatch, not a wider batch; per-lane
    # outputs are the same program, gated in tests/test_engine.py)
    @jax.jit
    def run_pair(stack, states, win, tv):
        outs = []
        for i in range(2):
            y, _ = enh._block_run_batch(stack[i], states, win, tv)
            outs.append(y)
        return jnp.stack(outs)

    stack2 = jnp.stack([batch, batch * jnp.float32(1.0001)])
    ys2 = run_pair(stack2, states, enh.win, t_valid)
    jax.block_until_ready(ys2)
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_rep // 2):
            ys2 = run_pair(stack2, states, enh.win, t_valid)
        jax.block_until_ready(ys2)
        windows.append((time.perf_counter() - t0) / (n_rep // 2) / 2)
    elapsed_pair = min(windows)
    elapsed = min(elapsed_pair, elapsed_single)
    dispatch = "pair" if elapsed_pair <= elapsed_single else "single"

    audio_seconds = batch_size * len(x) / fs
    value = audio_seconds / elapsed
    value_single_dispatch = audio_seconds / elapsed_single
    n_chips = max(len(jax.devices()), 1)
    value_per_chip = value / n_chips

    # ---- MU-solver kernel metrics.  The workhorse is the batched
    # per-column H-solve (nmf/solver.snmf_h_solve_columns), the realization
    # of sparse_nmf.m:186-285's per-frame m=1 solves, measured on the bench
    # spectrogram at production shapes.
    from se_snmf_nat_tpu.dsp.stft import analysis_frames
    from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_h_solve_columns

    s = cfg.signal
    mag, _ = analysis_frames(
        jnp.asarray(frames, jnp.float32), enh.win, s.fftlength, s.pow,
        s.dc_bin, s.nonzerofloor, s.preemph)
    v = jnp.tile(mag[:n_true].T, (1, batch_size))       # (F, B*T) columns
    w_sep = jnp.concatenate(
        [jnp.asarray(speech.b_dft, jnp.float32),
         jnp.asarray(noise.b_dft, jnp.float32)], axis=1)  # (513, 200)
    r = w_sep.shape[1]
    params = SnmfParams(beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
                        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
                        flr=1e-9, precision=cfg.runtime.matmul_precision)
    h0 = jnp.full((r, v.shape[1]), 0.5, jnp.float32)

    # chained timing: each solve's output (renormalized into the h0 range)
    # seeds the next, at conv_eps=0 (exactly max_iter loop trips per call —
    # a deterministic iteration count; the production early-stop path is
    # what the headline pipeline above exercises)
    import dataclasses

    params_fixed = dataclasses.replace(params, conv_eps=0.0)

    def _chain(h):
        return 0.3 + 0.4 * h / (jnp.mean(h) + 1e-6)

    h0s = [h0 * jnp.float32(1.0 + 0.05 * k) for k in range(6)]
    res = snmf_h_solve_columns(v, w_sep, h0s[-1], params_fixed)  # compile
    jax.block_until_ready(res.h)
    windows = []
    for wdx in range(5):
        h = h0s[wdx]
        t0 = time.perf_counter()
        for _ in range(8):
            h = _chain(snmf_h_solve_columns(v, w_sep, h, params_fixed).h)
        jax.block_until_ready(h)
        windows.append((time.perf_counter() - t0) / 8)
    mu_elapsed = min(windows)

    # ---- MU ceiling: the same loop stripped to its two GEMMs — the
    # irreducible compute + data movement of one MU trip at identical
    # shapes and precision.  mu_roofline_frac = solver rate / chain rate.
    from jax import lax as _lax

    w_norm = w_sep / jnp.sqrt(jnp.sum(w_sep * w_sep, axis=0))[None, :]

    @jax.jit
    def gemm_chain(h):
        def body(hh, _):
            g = jnp.matmul(w_norm, hh, precision=params.lax_precision)
            g = jnp.matmul(w_norm.T, g, precision=params.lax_precision)
            return g * jnp.float32(9.5e-3), None
        hh, _ = _lax.scan(body, h, None, length=params.max_iter)
        return hh

    jax.block_until_ready(gemm_chain(h0s[0]))            # compile
    windows = []
    for wdx in range(5):
        h = h0s[wdx]
        t0 = time.perf_counter()
        for _ in range(8):
            h = _chain(gemm_chain(h))
        jax.block_until_ready(h)
        windows.append((time.perf_counter() - t0) / 8)
    mu_ceiling_elapsed = min(windows)
    mu_roofline_frac = mu_ceiling_elapsed / mu_elapsed

    n_loop_iters = params.max_iter                      # exact at eps=0
    n_cols = v.shape[1]
    # a reference "MU iteration" is one H update of one frame column
    # (sparse_nmf.m:186-285 at m=1); the batched loop updates every column
    # each trip, so column-iterations = trips x columns
    mu_iters_per_s = n_loop_iters * n_cols / mu_elapsed
    # per loop trip: dmh = W^T(V/Lambda) and Lambda = W@H — two (F,r)x(r,n)
    # GEMM-class contractions => 2 * (2*F*r*n) FLOPs (elementwise excluded)
    f_bins = v.shape[0]
    flops_per_iter = 2 * (2.0 * f_bins * r * n_cols)
    achieved_flops = n_loop_iters * flops_per_iter / mu_elapsed
    # an f32 matmul at 'default' precision runs in TF32 on the H100
    # (chip_smoke.py device phase), so quote it against the TF32 peak
    mu_gemm_mfu = achieved_flops / (peak["tf32_flops"] * n_chips)

    # ---- STFT: the production analysis transform as ONE stacked matmul
    # (dsp/stft.dft_matrices_stacked), emitting mag + the unit-phasor
    # phase, timed at the module-default 'highest' precision inside one
    # program: a lax.scan whose carry is the full (mag, phase) pair, each
    # trip's input scaled by a scalar read from the previous trip's carry so
    # no trip's transform can be elided.
    stft_frames = jnp.asarray(
        np.tile(np.asarray(frames, np.float32), (batch_size, 1)))
    n_inner = 32

    @jax.jit
    def stft_chain(fr, mag0, ph0):
        def body(carry, _):
            mag_p, ph_p = carry
            # chain through a LIVE bin past the DC cut (bins < dc_bin are
            # the constant nonzerofloor)
            scale = 1.0 + 1e-3 * jnp.sin(mag_p[0, s.dc_bin]
                                         + ph_p[0, s.dc_bin])
            return analysis_frames(fr * scale, enh.win, s.fftlength, s.pow,
                                   s.dc_bin, s.nonzerofloor, s.preemph,
                                   dft_matmul=True), None
        (mg, ph), _ = jax.lax.scan(body, (mag0, ph0), None, length=n_inner)
        return mg, ph

    mag0 = jnp.zeros((stft_frames.shape[0], s.n_bins), jnp.float32)
    # the matmul analysis path returns the phase as a (T, 2F) unit phasor
    ph0 = jnp.zeros((stft_frames.shape[0], 2 * s.n_bins), jnp.float32)
    mg, ph = stft_chain(stft_frames, mag0, ph0)           # compile
    jax.block_until_ready((mg, ph))
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            mg, ph = stft_chain(stft_frames, mg, ph)
        jax.block_until_ready((mg, ph))
        windows.append((time.perf_counter() - t0) / 4)
    stft_elapsed = min(windows)
    n_stft_frames = stft_frames.shape[0] * n_inner
    stft_frames_per_s = n_stft_frames / stft_elapsed
    # two (T,640)x(640,F) matmuls per frame batch
    stft_flops_per_frame = 2 * (2.0 * stft_frames.shape[1] * s.n_bins)
    stft_tflops = stft_frames_per_s * stft_flops_per_frame / 1e12
    # minimum HBM traffic: read the time frames, write mag**pow + the
    # (2F) unit-phasor phase
    bytes_per_frame = 4 * (stft_frames.shape[1] + 3 * (s.fftlength // 2 + 1))
    stft_gbps = stft_frames_per_s * bytes_per_frame / 1e9
    stft_hbm_frac = stft_gbps * 1e9 / (peak["hbm_bytes_per_s"] * n_chips)

    print(json.dumps({
        "metric": "audio_seconds_per_s_per_chip",
        "value": round(value_per_chip, 2),
        "unit": "audio-s/s/chip (adaptive SNMF-NAT enhancement, "
                f"block-adaptive K={HEADLINE_PLAN['block_adapt']} "
                f"cap{HEADLINE_PLAN['block_iter_cap']} "
                f"bucket{HEADLINE_PLAN['frame_bucket']}, phasor matmul-DFT "
                f"{HEADLINE_PLAN.get('dft_precision') or 'highest'}/"
                f"{HEADLINE_PLAN.get('idft_precision') or 'highest'}, "
                f"f32, B={batch_size}, {dispatch}-dispatch)",
        "vs_baseline": round(value_per_chip / 100.0, 3),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": n_chips,
        "input": "M03" if args.seed is None else f"seed {args.seed}",
        "audio_s_per_s_single_dispatch": round(
            value_single_dispatch / n_chips, 2),
        "mu_iters_per_s": round(mu_iters_per_s, 0),
        "mu_gemm_tflops": round(achieved_flops / 1e12, 2),
        "mu_gemm_mfu_vs_tf32": round(mu_gemm_mfu, 4),
        "mu_ceiling_tflops": round(
            n_loop_iters * flops_per_iter / mu_ceiling_elapsed / 1e12, 2),
        "mu_roofline_frac": round(mu_roofline_frac, 4),
        "mu_solver_shape": f"F={f_bins} r={r} cols={n_cols} iters={n_loop_iters}",
        "stft_frames_per_s": round(stft_frames_per_s, 0),
        "stft_tflops": round(stft_tflops, 2),
        "stft_hbm_gbps": round(stft_gbps, 1),
        "stft_hbm_frac": round(stft_hbm_frac, 4),
    }))


if __name__ == "__main__":
    main()
