"""DSP layer: window identities, STFT/iSTFT round trip, framing semantics,
mel filterbank parity, splicing, DD smoothing."""

import numpy as np
import jax.numpy as jnp
import pytest

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic, hann_periodic
from se_snmf_nat_tpu.dsp.stft import (
    stream_frames, analysis_frames, synthesis_frames, overlap_add,
    stft_batch_train,
)
from se_snmf_nat_tpu.dsp.mel import mel_matrix
from se_snmf_nat_tpu.dsp.splice import frame_splice
from se_snmf_nat_tpu.dsp.smoothing import tf_dd, tf_dd_jax

CFG = default_config()
S = CFG.signal


def test_sqrt_hann_ola_identity():
    """sqrt-hann analysis+synthesis at 75% overlap with overlapscale=0.5 is
    a perfect-reconstruction pair: sum_k w^2(n-kH)*scale == 1."""
    w2 = hann_periodic(S.framelength)
    acc = np.zeros(S.framelength * 3)
    for k in range(0, len(acc) - S.framelength + 1, S.frameshift):
        acc[k:k + S.framelength] += w2
    mid = acc[S.framelength:-S.framelength] * S.overlapscale
    assert np.allclose(mid, 1.0, atol=1e-12)


def test_stream_frames_matches_queue_semantics():
    x = np.arange(1000, dtype=np.float64)
    frames = stream_frames(x, S.framelength, S.frameshift, n_flush=4)
    n_hops = len(x) // S.frameshift  # 6
    assert frames.shape == (n_hops + 4, S.framelength)
    # Simulate the reference queue
    q = np.zeros(S.framelength)
    for l in range(n_hops):
        q = np.concatenate([q[S.frameshift:],
                            x[l * S.frameshift:(l + 1) * S.frameshift]])
        assert np.array_equal(frames[l], q)
    assert np.all(frames[n_hops:] == 0.0)


def test_stft_istft_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16000) * 1000
    win = sqrt_hann_periodic(S.framelength)
    frames = stream_frames(x, S.framelength, S.frameshift, n_flush=4)
    mag, phase = analysis_frames(jnp.asarray(frames), jnp.asarray(win),
                                 S.fftlength, S.pow, dc_bin=0,
                                 nonzerofloor=0.0)
    out_frames = synthesis_frames(mag, phase, S.framelength, S.fftlength,
                                  jnp.asarray(win), S.pow, dc_bin_back=0,
                                  overlapscale=S.overlapscale)
    y = np.asarray(overlap_add(out_frames, S.frameshift))
    # reconstructed signal is the input delayed by the queue prepad
    pad = S.framelength - S.frameshift
    n = len(x) // S.frameshift * S.frameshift
    rec = y[pad: pad + n - pad]
    np.testing.assert_allclose(rec, x[: n - pad], rtol=0, atol=1e-6)


def test_analysis_dc_zeroing_and_floor():
    frames = np.ones((3, S.framelength))
    win = sqrt_hann_periodic(S.framelength)
    mag, _ = analysis_frames(jnp.asarray(frames), jnp.asarray(win),
                             S.fftlength, 2.0, dc_bin=5, nonzerofloor=1e-9)
    mag = np.asarray(mag)
    assert np.allclose(mag[:, :5], 1e-9)
    assert np.all(mag[:, 5:] >= 1e-9)


def test_overlap_add_matches_naive():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((7, S.framelength))
    got = np.asarray(overlap_add(jnp.asarray(frames), S.frameshift))
    want = np.zeros(6 * S.frameshift + S.framelength)
    for t in range(7):
        want[t * S.frameshift: t * S.frameshift + S.framelength] += frames[t]
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_stft_batch_train_frame_count():
    # MATLAB loop: while (1-based) start < len - fftlen
    x = np.zeros(10000)
    mag, _ = stft_batch_train(x, S.framelength, S.frameshift, S.fftlength,
                              5, sqrt_hann_periodic(S.framelength), 0.0)
    assert mag.shape[0] == S.n_bins
    # produced frames: starts 0,160,... < 10000-1024-1 → ceil(8975/160)=57
    produced = int(np.ceil((10000 - S.fftlength - 1) / S.frameshift))
    assert mag.shape[1] == len(x) // S.frameshift  # allocation
    assert np.all(mag[:, produced:] == 0)          # unproduced stay zero
    assert np.all(mag[:5, :produced] == 1e-6)      # DC rows


def test_mel_matrix_shape_and_partition():
    m = mel_matrix(S.fs, 64, S.fftlength)
    assert m.shape == (S.n_bins, 64)
    assert np.all(m >= 0) and np.all(m <= 1)
    # each filter has a peak of 1 and triangular support
    assert np.allclose(m.max(axis=0), 1.0)
    # interior bins are covered by at least one filter
    covered = (m.sum(axis=1) > 0)
    assert covered[10:500].all()


def test_frame_splice_identity_and_context():
    feat = np.arange(12, dtype=float).reshape(3, 4)
    assert frame_splice(feat, 0) is feat
    sp = frame_splice(feat, 1)
    assert sp.shape == (9, 4)
    # center block is the original
    np.testing.assert_array_equal(sp[3:6], feat)
    # leading block at t=0 is zero (no left context)
    assert np.all(sp[0:3, 0] == 0)
    np.testing.assert_array_equal(sp[0:3, 1:], feat[:, :3])


def test_tf_dd_numpy_vs_jax():
    rng = np.random.default_rng(2)
    x = rng.random((5, 30))
    a = 0.4
    want = tf_dd(x, a)
    got = np.asarray(tf_dd_jax(jnp.asarray(x.T), a)).T
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_srconv_rational():
    from se_snmf_nat_tpu.dsp.resample import srconv
    fs_in, fs_out = 48000, 16000
    t = np.arange(fs_in) / fs_in
    x = np.sin(2 * np.pi * 440 * t)
    y = srconv(x, fs_in, fs_out)
    assert len(y) == fs_out
    t2 = np.arange(fs_out) / fs_out
    want = np.sin(2 * np.pi * 440 * t2)
    # interior agreement (edges have filter transients)
    sl = slice(fs_out // 10, -fs_out // 10)
    assert np.abs(y[sl] - want[sl]).max() < 1e-3
    np.testing.assert_array_equal(srconv(x, fs_in, fs_in), x)


def test_ten2mat_unfolding():
    import jax.numpy as jnp
    from se_snmf_nat_tpu.multichannel import ten2mat
    rng = np.random.default_rng(0)
    t = rng.random((4, 3, 2))
    m = np.asarray(ten2mat(jnp.asarray(t)))
    # MATLAB: TF_mat(:, 1+(i-1)*r : i*r) = TF_ten(:,:,i)
    np.testing.assert_array_equal(m[:, 0:3], t[:, :, 0])
    np.testing.assert_array_equal(m[:, 3:6], t[:, :, 1])


def test_tiled_to_rank_small_rank():
    from se_snmf_nat_tpu.io.basis import BasisPair
    rng = np.random.default_rng(0)
    pair = BasisPair(b_dft=rng.random((8, 3)), b_mel=rng.random((4, 3)))
    wide = pair.tiled_to_rank(10)          # 3 -> 10 needs repeated tiling
    assert wide.b_dft.shape == (8, 10)
    assert wide.b_mel.shape == (4, 10)
    # column pattern follows the reference loop: [b, b, b, b(:, :1)]
    np.testing.assert_array_equal(wide.b_dft[:, 3:6], pair.b_dft)
    np.testing.assert_array_equal(wide.b_dft[:, 6:9], pair.b_dft)
    np.testing.assert_array_equal(wide.b_dft[:, 9], pair.b_dft[:, 0])
    assert pair.tiled_to_rank(3) is pair


def test_stream_frames_jax_matches_host():
    """Device-side framing (raw-sample upload path) is value-identical to
    the host stream_frames closed form, including partial-hop truncation,
    zeroed flush frames, and bucket padding."""
    import jax.numpy as jnp
    from se_snmf_nat_tpu.dsp.stft import stream_frames, stream_frames_jax
    rng = np.random.default_rng(5)
    flen, shift, n_flush = 640, 160, 4
    for n in (1603, 6400, 6401):
        x = rng.standard_normal(n)
        want = stream_frames(x, flen, shift, n_flush)
        t_true = want.shape[0]
        t_bucket = 64                      # bucketed frame count
        n_hops = n // shift
        smp = np.zeros(t_bucket * shift)
        smp[: n_hops * shift] = x[: n_hops * shift]
        got = np.asarray(stream_frames_jax(
            jnp.asarray(smp), jnp.asarray(n_hops), flen, shift))
        assert got.shape == (t_bucket, flen)
        np.testing.assert_array_equal(got[:t_true - n_flush],
                                      want[:t_true - n_flush])
        # flush + bucket-padding frames are exactly zero
        assert not got[t_true - n_flush:].any()


def test_pack_samples_for_upload():
    from se_snmf_nat_tpu.dsp.stft import pack_samples_for_upload
    # integer-valued int16-scale doubles -> int16 wire format
    a = np.array([[0.0, -32768.0, 32767.0, 5.0]])
    p = pack_samples_for_upload(a)
    assert p.dtype == np.int16
    np.testing.assert_array_equal(p.astype(np.float64), a)
    # non-integer or out-of-range values fall back to the compute dtype
    assert pack_samples_for_upload(np.array([[0.5]])).dtype == np.float32
    assert pack_samples_for_upload(
        np.array([[40000.0]]), np.float64).dtype == np.float64


def test_dft_matmul_matches_fft():
    """The matmul transform path (dsp/stft.dft_matrices — the f32
    production plans' transform) agrees with the jnp.fft path to fp tolerance in
    both directions, including preemphasis and dc handling."""
    rng = np.random.default_rng(3)
    win = jnp.asarray(sqrt_hann_periodic(640), jnp.float32)
    fr = jnp.asarray(rng.standard_normal((33, 640)) * 1000.0, jnp.float32)
    for preemph in (0.0, 0.92):
        m1, p1 = analysis_frames(fr, win, 1024, 2.0, 5, 1e-6, preemph)
        m2, p2 = analysis_frames(fr, win, 1024, 2.0, 5, 1e-6, preemph,
                                 dft_matmul=True)
        assert float(jnp.max(jnp.abs(m1 - m2))) < 1e-5 * float(jnp.max(m1))
        # the matmul path returns the phase as a (T, 2F) unit phasor
        # [cos | sin]; compare against the fft path's angle on the unit
        # circle (atan2 branch-safe)
        f = m1.shape[-1]
        assert p2.shape == (m2.shape[0], 2 * f)
        ph2 = (p2[:, :f] + 1j * p2[:, f:]).astype(jnp.complex128)
        assert float(jnp.max(jnp.abs(jnp.exp(1j * p1.astype(jnp.float64))
                                     - ph2))) < 1e-4
        # phasor magnitudes stay on the unit circle (incl. guarded bins)
        assert float(jnp.max(jnp.abs(jnp.abs(ph2) - 1.0))) < 1e-5
        y1 = synthesis_frames(m1, p1, 640, 1024, win, 2.0, 5, 0.5, preemph)
        # the matmul synthesis accepts BOTH representations: an angle
        # phase (fft-path interop) and the phasor from its own analysis
        y2 = synthesis_frames(m1, p1, 640, 1024, win, 2.0, 5, 0.5, preemph,
                              dft_matmul=True)
        y3 = synthesis_frames(m2, p2, 640, 1024, win, 2.0, 5, 0.5, preemph,
                              dft_matmul=True)
        scale = float(jnp.max(jnp.abs(y1)))
        assert float(jnp.max(jnp.abs(y1 - y2))) < 1e-5 * scale
        assert float(jnp.max(jnp.abs(y1 - y3))) < 1e-5 * scale


def test_dft_matmul_precision_plumbing():
    """The per-direction precision kwargs (dsp/stft analysis/synthesis
    ``precision``, threaded from SnmfEnhancer dft_precision/idft_precision
    — the headline plan runs analysis 'high' / synthesis 'default') must
    reach the transform without changing semantics.  On the CPU backend
    every matmul precision tier is the same f32 math, so all combos are
    gated EXACTLY equal here; on the H100 'high' and 'default' are TF32
    (chip_smoke.py device phase), which chip_smoke.py checks end to end.
    """
    rng = np.random.default_rng(7)
    win = jnp.asarray(sqrt_hann_periodic(640), jnp.float32)
    fr = jnp.asarray(rng.standard_normal((9, 640)) * 800.0, jnp.float32)
    base_m, base_p = analysis_frames(fr, win, 1024, 2.0, 5, 1e-6, 0.0,
                                     dft_matmul=True)
    base_y = synthesis_frames(base_m, base_p, 640, 1024, win, 2.0, 5, 0.5,
                              0.0, dft_matmul=True)
    for prec in ("highest", "high", "default"):
        m, p = analysis_frames(fr, win, 1024, 2.0, 5, 1e-6, 0.0,
                               dft_matmul=True, precision=prec)
        y = synthesis_frames(m, p, 640, 1024, win, 2.0, 5, 0.5, 0.0,
                             dft_matmul=True, precision=prec)
        np.testing.assert_array_equal(np.asarray(m), np.asarray(base_m))
        np.testing.assert_array_equal(np.asarray(p), np.asarray(base_p))
        np.testing.assert_array_equal(np.asarray(y), np.asarray(base_y))
