"""Hop-by-hop streaming session vs the offline pipeline: bit-identical."""

from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu.stream.streaming import StreamingSession


@pytest.fixture(scope="module")
def enh():
    cfg = default_config()
    cfg = cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        adapt=replace(cfg.adapt, r_a=4, m_a=10),
        nmf=replace(cfg.nmf, max_iter=6),
    )
    rng = np.random.default_rng(0)
    f = cfg.signal.n_bins
    bx = rng.random((f, 8)) + 1e-3
    bd = rng.random((f, 8)) + 1e-3
    return SnmfEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64,
                        matlab_ad_blk_init=False)


@pytest.mark.slow
def test_streaming_bit_identical_to_offline(enh, m03_wav):
    x = m03_wav[0][:16000]
    want = enh.enhance(x)
    sess = StreamingSession(enh)
    parts = [sess.push(x)]
    parts.append(sess.flush())
    got = np.concatenate(parts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_streaming_irregular_chunks(enh, m03_wav):
    """Mic-style irregular chunk sizes (1..700 samples) give the same
    stream as one big push."""
    x = m03_wav[0][:12000]
    want = enh.enhance(x)
    sess = StreamingSession(enh)
    rng = np.random.default_rng(1)
    parts = []
    i = 0
    while i < len(x):
        n = int(rng.integers(1, 700))
        parts.append(sess.push(x[i: i + n]))
        i += n
    parts.append(sess.flush())
    got = np.concatenate([p for p in parts if len(p)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_streaming_state_continues(enh, m03_wav):
    """A session seeded with a previous utterance's state matches the
    chained offline call."""
    x = m03_wav[0][:12000]
    _, st = enh.enhance(x, return_state=True)
    want = enh.enhance(x, state=st)
    sess = StreamingSession(enh, state=st)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_block_mode_bit_identical(enh, m03_wav):
    """block_frames=8 amortizes dispatch; outputs stay bit-identical."""
    x = m03_wav[0][:16000]
    want = enh.enhance(x)
    sess = StreamingSession(enh, block_frames=8)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_block_adaptive_streaming_equals_offline_plan(enh, m03_wav):
    """use_block_adaptive streaming must reproduce the OFFLINE
    block-adaptive plan bit-for-bit — same plan, different driver.  (Its
    deviation from the exact per-frame plan is the documented
    approximation, quality-gated elsewhere with real dictionaries.)"""
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as _SE
    x = m03_wav[0][:16000]
    enh_blk = _SE(enh.cfg, *enh._bases, dtype=enh.dtype,
                  matlab_ad_blk_init=False, block_adapt=8)
    want = enh_blk.enhance(x)
    sess = StreamingSession(enh, block_frames=8, use_block_adaptive=True)
    got = np.concatenate([sess.push(x), sess.flush()])
    n = min(len(got), len(want))
    np.testing.assert_array_equal(got[:n], want[:n])


@pytest.mark.slow
def test_dft_matmul_propagates_to_streaming(enh, m03_wav):
    """An enhancer built with dft_matmul=True must stream through the SAME
    matmul transform it uses offline (review finding: the sessions
    previously fell back to jnp.fft, silently breaking the documented
    streaming-vs-offline bit-identity for that opt-in configuration)."""
    import jax.numpy as _jnp
    x = m03_wav[0][:16000]
    enh_dm = SnmfEnhancer(enh.cfg, *enh._bases, dtype=enh.dtype,
                          matlab_ad_blk_init=False, dft_matmul=True)
    sess = StreamingSession(enh_dm, block_frames=8)
    # structural proof: the session's compiled block program contains NO
    # fft op (the matmul transform replaced it); the fft enhancer's does
    s = enh.cfg.signal
    ex = (_jnp.zeros((8, s.framelength), enh.dtype), sess.state,
          _jnp.asarray(1, _jnp.int32), _jnp.asarray(8, _jnp.int32))
    assert "fft" not in sess._run_block.lower(*ex).as_text()
    assert "fft" in StreamingSession(enh, block_frames=8)._run_block \
        .lower(*ex).as_text()
    # value agreement with the offline dft_matmul plan (bit-identity does
    # not hold here: an 8-frame block tiles the f64 DFT matmul differently
    # from the whole-utterance batch, ~1e-12 — unlike the row-wise fft)
    want = enh_dm.enhance(x, quantize=False)
    got = np.concatenate([sess.push(x, quantize=False),
                          sess.flush(quantize=False)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_adaptation_toggle_off_equals_config_off(enh, m03_wav):
    """SE_GUI.m:393-435 push-to-talk parity, half 1: a session with
    set_adaptation(False) from the start must produce EXACTLY the output
    of a plan built with adaptation off in the config (supervised frames
    leave the dictionary untouched), and the dictionary head must stay
    bit-identical to its initial value."""
    x = m03_wav[0][:12000]
    cfg_off = enh.cfg.evolve(
        adapt=replace(enh.cfg.adapt, adapt_train_n=False))
    enh_off = SnmfEnhancer(cfg_off, *enh._bases, dtype=enh.dtype,
                           matlab_ad_blk_init=False)
    want = enh_off._run_masked(
        jnp.asarray(enh_off._pad_frames(enh_off.frames_for(x)), enh.dtype),
        enh_off.initial_state(),
        jnp.asarray(enh_off.frames_for(x).shape[0], jnp.int32))[0]
    sess = StreamingSession(enh, block_frames=4)
    sess.set_adaptation(False)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(np.asarray(sess.state.b_d_head),
                                  np.asarray(enh.initial_state().b_d_head))
    # the config-off run of the same engine (exact scan path, same state
    # carry) — compare via the enhancer's scan on the toggled session's
    # semantics: outputs must agree exactly
    ref = enh_off.enhance(x)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.slow
def test_adaptation_toggle_mid_stream(enh, m03_wav):
    """PTT parity, half 2: toggling OFF mid-stream freezes the dictionary
    (bit-identical head across the off span) and toggling back ON resumes
    adaptation with state continuity; the toggled stream differs from the
    always-on stream only after the first toggle point."""
    x = m03_wav[0][:18000]
    third = 6000
    sess_on = StreamingSession(enh, block_frames=4)
    out_on = [sess_on.push(x[:third])]
    head_after1_on = np.asarray(sess_on.state.b_d_head)
    out_on.append(sess_on.push(x[third: 2 * third]))
    out_on.append(sess_on.push(x[2 * third:]))
    out_on.append(sess_on.flush())

    sess = StreamingSession(enh, block_frames=4)
    out_t = [sess.push(x[:third])]
    # identical prefix while both adapt
    np.testing.assert_array_equal(np.asarray(sess.state.b_d_head),
                                  head_after1_on)
    out_t.append(sess.set_adaptation(False))
    head_frozen = np.asarray(sess.state.b_d_head)
    out_t.append(sess.push(x[third: 2 * third]))
    np.testing.assert_array_equal(np.asarray(sess.state.b_d_head),
                                  head_frozen)  # untouched while off
    out_t.append(sess.set_adaptation(True))
    out_t.append(sess.push(x[2 * third:]))
    out_t.append(sess.flush())
    # adaptation resumed: the head moved again after re-enabling
    assert not np.array_equal(np.asarray(sess.state.b_d_head), head_frozen)
    # and the toggle changed the enhancement (lambda_dav path diverges)
    got = np.concatenate([p for p in out_t if len(p)])
    want = np.concatenate([p for p in out_on if len(p)])
    assert got.shape == want.shape
    assert not np.array_equal(got, want)
    # prefix (first segment minus one block of latency) is identical
    n_pre = len(out_on[0]) - 4 * enh.cfg.signal.frameshift
    np.testing.assert_array_equal(got[:n_pre], want[:n_pre])


def test_adaptation_toggle_block_plan(enh, m03_wav):
    """The block-adaptive plan honors state.adapt_on the same way: running
    it with the toggle off is bit-identical to the same plan built with
    adaptation off in the config."""
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as _SE
    x = m03_wav[0][:12000]
    enh_blk = _SE(enh.cfg, *enh._bases, dtype=enh.dtype,
                  matlab_ad_blk_init=False, block_adapt=8)
    cfg_off = enh.cfg.evolve(
        adapt=replace(enh.cfg.adapt, adapt_train_n=False))
    enh_blk_off = _SE(cfg_off, *enh._bases, dtype=enh.dtype,
                      matlab_ad_blk_init=False, block_adapt=8)
    st_off = enh_blk.initial_state()._replace(adapt_on=jnp.asarray(False))
    got, st_g = enh_blk.enhance(x, state=st_off, return_state=True)
    want = enh_blk_off.enhance(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(st_g.b_d_head),
                                  np.asarray(st_off.b_d_head))


@pytest.mark.slow
def test_adaptation_toggle_mid_block_defers_to_boundary(enh, m03_wav):
    """Review finding (r4): a mid-block set_adaptation on a BLOCK-ADAPTIVE
    session used to flush the partial block through the exact per-frame
    scan — a different algorithm for those frames — and permanently shift
    the session's block cadence.  The fix defers the toggle to the next
    block boundary, so a mid-block call must be bit-identical to calling
    at the boundary."""
    x = m03_wav[0][:16000]
    s = enh.cfg.signal
    B = 8
    cut = s.frameshift * (2 * B + 3)    # 3 hops INTO the third block

    sess_mid = StreamingSession(enh, block_frames=B,
                                use_block_adaptive=True)
    out_a = [sess_mid.push(x[:cut])]
    out_a.append(sess_mid.set_adaptation(False))
    out_a.append(sess_mid.push(x[cut:]))
    out_a.append(sess_mid.flush())

    bcut = s.frameshift * (3 * B)       # exactly the third block's end
    sess_bnd = StreamingSession(enh, block_frames=B,
                                use_block_adaptive=True)
    out_b = [sess_bnd.push(x[:bcut])]
    out_b.append(sess_bnd.set_adaptation(False))
    out_b.append(sess_bnd.push(x[bcut:]))
    out_b.append(sess_bnd.flush())

    np.testing.assert_array_equal(np.concatenate(out_a),
                                  np.concatenate(out_b))
    for f in sess_mid.state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sess_mid.state, f)),
                                      np.asarray(getattr(sess_bnd.state, f)),
                                      err_msg=f)
