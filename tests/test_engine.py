"""JAX frame engine + pipeline vs the float64 oracle.

The gold standard: in float64 the whole JAX pipeline (STFT -> scan(engine)
-> iSTFT -> OLA -> quantize) must reproduce the oracle bit-exactly after
int16 quantization.  (In float32, the adaptive config is chaotic — binary
adaptation gates amplify last-ulp noise — so production accuracy is gated
on the deterministic sub-paths and on x64 equivalence here.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from se_snmf_nat_tpu.config import default_config, preset
from se_snmf_nat_tpu.enhance.blk_sparse import block_sparsity_q
from se_snmf_nat_tpu.oracle.engine_np import blk_sparse_np
from se_snmf_nat_tpu.oracle.runner_np import enhance_samples_oracle
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer


@pytest.fixture(scope="module")
def short_clip(m03_wav):
    x, fs = m03_wav
    return x[:12000]  # 0.75 s → ~79 frames (covers init + adaptation + blk)


def _enhancer(cfg, bases, dtype):
    speech, noise = bases
    if cfg.sep.b_sep_mode == "Mel":
        b1_x, b1_d = speech.b_mel, noise.b_mel
    else:
        b1_x, b1_d = speech.b_dft, noise.b_dft
    return SnmfEnhancer(cfg, b1_x, b1_d, speech.b_dft, noise.b_dft,
                        dtype=dtype)


def _oracle(cfg, bases, x, **kw):
    speech, noise = bases
    if cfg.sep.b_sep_mode == "Mel":
        b1_x, b1_d = speech.b_mel, noise.b_mel
    else:
        b1_x, b1_d = speech.b_dft, noise.b_dft
    return enhance_samples_oracle(x, cfg, b1_x, b1_d, speech.b_dft,
                                  noise.b_dft, **kw)


def test_blk_sparse_matches_oracle():
    cfg = default_config()
    rng = np.random.default_rng(0)
    f = cfg.signal.n_bins
    r_blk = rng.random((f, cfg.blk.p_len_l))
    x = rng.random(f) + 0.01
    d = rng.random(f) + 0.01
    for l in (5, 30):  # below and above the P_len_l warmup
        q_ref, r_ref = blk_sparse_np(x[:, None], d[:, None], r_blk, l, cfg)
        q, r_new = block_sparsity_q(
            jnp.asarray(x), jnp.asarray(d), jnp.asarray(r_blk),
            jnp.asarray(l), n_bins=f, p_len_k=cfg.blk.p_len_k,
            p_len_l=cfg.blk.p_len_l, dc_bin=cfg.signal.dc_bin,
            gap=cfg.blk.blk_gap, alpha_p=cfg.blk.alpha_p, nonzerofloor=1e-9)
        np.testing.assert_allclose(np.asarray(q), q_ref[:, 0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(r_new), r_ref, atol=1e-15)


def test_blk_sparse_f32_windows_of_tiny_values_stay_finite():
    """f32 Q on a ring whose low bins are large and whose upper windows hold
    values ~1e-6: window sums taken as differences of running cumsums
    cancel below zero there and the L2 sqrt returned NaN, which then
    poisoned the exact plan's whole output (seeded speech on the H100)."""
    cfg = default_config()
    f, p = cfg.signal.n_bins, cfg.blk.p_len_l
    rng = np.random.default_rng(1)
    r_blk = np.where(np.arange(f)[:, None] < 200, 1.0,
                     1e-6 * (1.0 + rng.random((f, p))))
    x = np.where(np.arange(f) < 200, 1.0, 1e-6) * (1.0 + rng.random(f))
    d = np.ones(f)
    q_ref, _ = blk_sparse_np(x[:, None], d[:, None], r_blk, 30, cfg)
    q, _ = block_sparsity_q(
        jnp.asarray(x, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(r_blk, jnp.float32), jnp.asarray(30), n_bins=f,
        p_len_k=cfg.blk.p_len_k, p_len_l=p, dc_bin=cfg.signal.dc_bin,
        gap=cfg.blk.blk_gap, alpha_p=cfg.blk.alpha_p, nonzerofloor=1e-9)
    assert np.isfinite(np.asarray(q)).all()
    np.testing.assert_allclose(np.asarray(q), q_ref[:, 0], atol=1e-4)


def test_blk_sparse_block_batch_matches_sequential():
    """The block plan's whole-block Q (banded-GEMM window sums,
    make_block_sparsity_q_block) must reproduce the sequential shift-ring
    formulation frame by frame — including the ring state at the block
    boundary and the valid-prefix (padding) gating."""
    from se_snmf_nat_tpu.enhance.blk_sparse import (
        make_block_sparsity_q_block, snr_column)
    cfg = default_config()
    f = cfg.signal.n_bins
    p = cfg.blk.p_len_l
    k_block = 8
    rng = np.random.default_rng(2)
    kw = dict(n_bins=f, p_len_k=cfg.blk.p_len_k, p_len_l=p,
              dc_bin=cfg.signal.dc_bin, gap=cfg.blk.blk_gap,
              alpha_p=cfg.blk.alpha_p)
    qb = make_block_sparsity_q_block(k_block, **kw)
    xm = rng.random((3 * k_block, f)) + 0.01
    dm = rng.random((3 * k_block, f)) + 0.01
    for n_valid_last in (k_block, 3):      # full last block / padded tail
        ring_seq = jnp.zeros((f, p))
        ring_blk = jnp.zeros((f, p))
        for b in range(3):
            ls = jnp.arange(b * k_block + 1, (b + 1) * k_block + 1)
            n_valid = k_block if b < 2 else n_valid_last
            xm_b = jnp.asarray(xm[b * k_block: (b + 1) * k_block])
            dm_b = jnp.asarray(dm[b * k_block: (b + 1) * k_block])
            snr_b = jax.vmap(lambda x, d: snr_column(x, d, 1e-9))(xm_b, dm_b)
            q_blk, ring_blk = qb(snr_b, ring_blk, ls,
                                 jnp.asarray(n_valid, jnp.int32))
            for j in range(k_block):
                q_ref, ring_new = block_sparsity_q(
                    xm_b[j], dm_b[j], ring_seq, ls[j],
                    nonzerofloor=1e-9, **kw)
                if j < n_valid:
                    ring_seq = ring_new
                    np.testing.assert_allclose(np.asarray(q_blk[j]),
                                               np.asarray(q_ref),
                                               rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(ring_blk), np.asarray(ring_seq),
                                   rtol=0, atol=1e-15)


def test_blk_sparse_gap1_recurrence():
    """gap=1 exercises the true DD recurrence path."""
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(blk=replace(cfg.blk, blk_gap=1))
    rng = np.random.default_rng(1)
    f = cfg.signal.n_bins
    r_blk = rng.random((f, cfg.blk.p_len_l))
    x, d = rng.random(f) + 0.01, rng.random(f) + 0.01
    q_ref, _ = blk_sparse_np(x[:, None], d[:, None], r_blk, 30, cfg)
    q, _ = block_sparsity_q(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(r_blk), jnp.asarray(30),
        n_bins=f, p_len_k=cfg.blk.p_len_k, p_len_l=cfg.blk.p_len_l,
        dc_bin=cfg.signal.dc_bin, gap=1, alpha_p=cfg.blk.alpha_p,
        nonzerofloor=1e-9)
    np.testing.assert_allclose(np.asarray(q), q_ref[:, 0], atol=1e-12)


@pytest.mark.slow
def test_pipeline_x64_bitexact_vs_oracle(reference_bases, short_clip):
    cfg = default_config()
    want = _oracle(cfg, reference_bases, short_clip)
    got = _enhancer(cfg, reference_bases, jnp.float64).enhance(short_clip)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_pipeline_wiener_noadapt_preset(reference_bases, short_clip):
    """SNMF baseline preset (fixed basis, Wiener, no adaptation, preemph)."""
    cfg = preset("snmf")
    want = _oracle(cfg, reference_bases, short_clip)
    got = _enhancer(cfg, reference_bases, jnp.float64).enhance(short_clip)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_pipeline_semisupervised_preset(reference_bases, short_clip):
    """Co-updating the noise basis during the H-solve (discarded W)."""
    cfg = preset("semisupervised")
    bases = reference_bases
    # r_d=50 in this preset: narrow the noise basis like the loader would
    speech, noise = bases
    from se_snmf_nat_tpu.io.basis import BasisPair
    noise50 = BasisPair(noise.b_dft[:, :50], noise.b_mel[:, :50])
    want = enhance_samples_oracle(short_clip, cfg, speech.b_dft,
                                  noise50.b_dft, speech.b_dft, noise50.b_dft)
    enh = SnmfEnhancer(cfg, speech.b_dft, noise50.b_dft, speech.b_dft,
                       noise50.b_dft, dtype=jnp.float64)
    got = enh.enhance(short_clip)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_pipeline_mel_mode(reference_bases, short_clip):
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, b_sep_mode="Mel"))
    want = _oracle(cfg, reference_bases, short_clip)
    got = _enhancer(cfg, reference_bases, jnp.float64).enhance(short_clip)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_batch_matches_single(reference_bases, short_clip):
    cfg = default_config()
    enh = _enhancer(cfg, reference_bases, jnp.float64)
    a = short_clip
    b = short_clip[:8000]
    outs = enh.enhance_batch([a, b])
    np.testing.assert_array_equal(outs[0], enh.enhance(a))
    np.testing.assert_array_equal(outs[1], enh.enhance(b))


@pytest.mark.slow
def test_block_fixed_iter_close_to_eps_plan(reference_bases, short_clip):
    """block_fixed_iter (capped solves drop the per-column early stop and
    with it the per-trip convergence-cost pass) is a documented
    trajectory change: columns that froze early now update to the cap.
    Outputs must stay tightly correlated with the early-stop plan — the
    shipped configuration is additionally golden-gated (headline.py)."""
    cfg = default_config()
    speech, noise = reference_bases
    kw = dict(dtype=jnp.float64, block_adapt=16, frame_bucket=16,
              block_iter_cap=32)
    a = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                     noise.b_dft, **kw).enhance(short_clip)
    b = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                     noise.b_dft, **kw,
                     block_fixed_iter=True).enhance(short_clip)
    assert not np.array_equal(a, b)          # it IS a different trajectory
    corr = np.corrcoef(a.astype(np.float64), b.astype(np.float64))[0, 1]
    assert corr > 0.995, corr


@pytest.mark.slow
def test_batch_micro_batch_identical(reference_bases, short_clip):
    """Double-buffered micro-batching (chunked dispatch with in-order
    fetch, stream/pipeline.enhance_batch) is value-identical to the
    single-call path, including a lane-padded tail chunk."""
    cfg = default_config()
    enh = _enhancer(cfg, reference_bases, jnp.float64)
    xs = [short_clip, short_clip[:8000], short_clip[:9600]]
    want = enh.enhance_batch(xs)
    got = enh.enhance_batch(xs, micro_batch=2)   # chunks: [2, 1(padded)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_state_carry_across_utterances(reference_bases, short_clip):
    """B_D_u.mat-style persistence: chaining state changes the second
    utterance's output (the adapted dictionary carries over)."""
    cfg = default_config()
    enh = _enhancer(cfg, reference_bases, jnp.float64)
    out1, st = enh.enhance(short_clip, return_state=True)
    out2_chained = enh.enhance(short_clip, state=st)
    out2_fresh = enh.enhance(short_clip)
    assert not np.array_equal(out2_chained, out2_fresh)


@pytest.mark.slow
def test_fast_plan_bit_equal_scan_plan(reference_bases, short_clip):
    """The non-adaptive fast plan (whole-utterance batched solve + light
    gain scan) must equal the per-frame scan plan."""
    cfg = preset("snmf")
    speech, noise = reference_bases
    enh_fast = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                            noise.b_dft, dtype=jnp.float64)
    assert enh_fast._fast_run is not None
    got = enh_fast.enhance(short_clip)
    # force the scan plan on the same enhancer
    enh_fast._fast_run = None
    want = enh_fast.enhance(short_clip)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.001


@pytest.mark.slow
def test_fast_plan_iter_cap_output_invariant(reference_bases, short_clip):
    """Capping the fast plan's single batched MU solve at 40 iterations
    leaves the output essentially unchanged (on-chip: corr 1.00000 on full
    M03, 9772 -> 15497 au-s/s — only straggler columns with oscillating
    relative-cost tests run past ~iteration 31, and they drag the whole
    batched while_loop to max_iter; same finding as the block plan's
    block_iter_cap sweep).  Opt-in via cfg.nmf.max_iter, default 100 so
    the x64 oracle parity gates stay pinned."""
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    speech, noise = reference_bases
    def out(max_iter):
        c = cfg.evolve(nmf=replace(cfg.nmf, max_iter=max_iter))
        enh = SnmfEnhancer(c, speech.b_dft, noise.b_dft, speech.b_dft,
                           noise.b_dft, dtype=jnp.float32)
        assert enh._fast_run is not None
        return enh.enhance(short_clip).astype(np.float64)
    a, b = out(100), out(40)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.9999, corr
    d = np.abs(a - b)
    assert np.mean(d) < 20.0, np.mean(d)


@pytest.mark.slow
def test_fast_plan_fixed_iter_output_invariant(reference_bases, short_clip):
    """Fixed-iteration fast plan (cfg.nmf.max_iter=20, conv_eps=0 — a pure
    config recipe, no code switch): dropping the per-column early stop
    engages the solver's cost-skip and runs every column exactly 20
    iterations; output stays essentially the default plan's (corr .9990
    on this short clip, .9999 on a 1 s M03 prefix; trend 24/20/16 ->
    .99994/.99992/.99978 there, so 20 is the floor with margin)."""
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    speech, noise = reference_bases

    def out(max_iter, eps):
        c = cfg.evolve(nmf=replace(cfg.nmf, max_iter=max_iter,
                                   conv_eps=eps))
        enh = SnmfEnhancer(c, speech.b_dft, noise.b_dft, speech.b_dft,
                           noise.b_dft, dtype=jnp.float64)
        assert enh._fast_run is not None
        return enh.enhance(short_clip).astype(np.float64)

    a, b = out(100, cfg.nmf.conv_eps), out(20, 0.0)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.998, corr
    d = np.abs(a - b)
    assert np.mean(d) < 100.0, np.mean(d)   # measured 53.7 LSB int16-scale


@pytest.mark.slow
def test_block_plan_refit_cap_output_stable(reference_bases, short_clip):
    """block_refit_cap=16 leaves the block plan's output essentially
    unchanged (on-chip at production shapes it is also speed-neutral —
    the refit W-solves exit early on their own; block_adaptive.py)."""
    cfg = default_config()
    speech, noise = reference_bases
    def out(rc):
        enh = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                           noise.b_dft, dtype=jnp.float32, block_adapt=16,
                           block_refit_cap=rc)
        return enh.enhance(short_clip).astype(np.float64)
    a, b = out(0), out(16)
    assert np.corrcoef(a, b)[0, 1] > 0.999


@pytest.mark.slow
def test_fast_plan_mmse_blk_config(reference_bases, short_clip):
    """MMSE + block sparsity, adaptation off — fast vs scan."""
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    speech, noise = reference_bases
    enh = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                       noise.b_dft, dtype=jnp.float64)
    assert enh._fast_run is not None
    got = enh.enhance(short_clip)
    enh._fast_run = None
    want = enh.enhance(short_clip)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.001


@pytest.mark.slow
def test_block_adaptive_close_to_exact(reference_bases, short_clip):
    """Block-adaptive plan (K=8): bounded deviation from the exact
    per-frame-refit scan (documented approximation)."""
    cfg = default_config()
    speech, noise = reference_bases
    exact = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                         noise.b_dft, dtype=jnp.float64)
    blocked = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                           noise.b_dft, dtype=jnp.float64, block_adapt=8)
    a = exact.enhance(short_clip).astype(np.float64)
    b = blocked.enhance(short_clip).astype(np.float64)
    assert a.shape == b.shape
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.97, corr


@pytest.mark.slow
def test_block_adaptive_state_carry(reference_bases, short_clip):
    cfg = default_config()
    speech, noise = reference_bases
    enh = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                       noise.b_dft, dtype=jnp.float64, block_adapt=8)
    _, st = enh.enhance(short_clip, return_state=True)
    chained = enh.enhance(short_clip, state=st)
    fresh = enh.enhance(short_clip)
    assert not np.array_equal(chained, fresh)


@pytest.mark.slow
def test_block_adaptive_mel_mode(reference_bases, short_clip):
    from dataclasses import replace
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, b_sep_mode="Mel"))
    speech, noise = reference_bases
    exact = SnmfEnhancer(cfg, speech.b_mel, noise.b_mel, speech.b_dft,
                         noise.b_dft, dtype=jnp.float64)
    blocked = SnmfEnhancer(cfg, speech.b_mel, noise.b_mel, speech.b_dft,
                           noise.b_dft, dtype=jnp.float64, block_adapt=8)
    a = exact.enhance(short_clip).astype(np.float64)
    b = blocked.enhance(short_clip).astype(np.float64)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.95, corr


@pytest.mark.slow
def test_warm_start_plan(reference_bases, short_clip):
    """Warm-start H-solve (documented deviation, measured negative result —
    see engine.py docstring): frame 1 is bit-equal to the cold plan by
    construction; later frames diverge but stay sane."""
    cfg = default_config()
    speech, noise = reference_bases
    cold = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                        noise.b_dft, dtype=jnp.float64)
    warm = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                        noise.b_dft, dtype=jnp.float64, warm_start=True)
    a = cold.enhance(short_clip)
    b = warm.enhance(short_clip)
    assert a.shape == b.shape
    # first emitted hop comes from pre-divergence frames (delay=3; the
    # engine output of frame 1 is identical, so hop 1 matches exactly)
    np.testing.assert_array_equal(a[:160], b[:160])
    corr = np.corrcoef(a.astype(np.float64), b.astype(np.float64))[0, 1]
    assert corr > 0.5, corr
    with pytest.raises(ValueError):
        SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                     noise.b_dft, warm_start=True, block_adapt=8)


@pytest.mark.slow
def test_block_adaptive_honors_update_period(reference_bases, short_clip):
    """adapt.update_period gates block refits just as it gates engine
    refits (engine.py:214,234): with a period longer than the clip's
    trigger count, the dictionary head never moves; at period=1 it does."""
    from dataclasses import replace
    cfg = default_config()
    speech, noise = reference_bases
    cfg_slow = cfg.evolve(adapt=replace(cfg.adapt, overlap_m_a=100.0))
    assert cfg_slow.adapt.update_period > 1000
    enh = SnmfEnhancer(cfg_slow, speech.b_dft, noise.b_dft, speech.b_dft,
                       noise.b_dft, dtype=jnp.float64, block_adapt=8)
    _, st = enh.enhance(short_clip, return_state=True)
    np.testing.assert_array_equal(
        np.asarray(st.b_d_head), np.asarray(enh.initial_state().b_d_head))
    # the switch counter still advanced (triggers occurred, no refit due)
    assert int(st.update_switch) > 1
    enh1 = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                        noise.b_dft, dtype=jnp.float64, block_adapt=8)
    _, st1 = enh1.enhance(short_clip, return_state=True)
    assert not np.array_equal(np.asarray(st1.b_d_head),
                              np.asarray(enh1.initial_state().b_d_head))


@pytest.mark.slow
def test_block_adaptive_padding_inert(reference_bases, short_clip):
    """Bucket-padding frames must not touch the carried state or output
    (they previously polluted the adaptation rings and dictionary)."""
    cfg = default_config()
    speech, noise = reference_bases
    kw = dict(dtype=jnp.float64, block_adapt=8)
    # short_clip: 12000 samples -> 79 frames; bucket 80 => 1 pad frame,
    # bucket 240 => 161 pad frames
    a = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                     noise.b_dft, frame_bucket=80, **kw)
    b = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                     noise.b_dft, frame_bucket=240, **kw)
    ya, sta = a.enhance(short_clip, return_state=True)
    yb, stb = b.enhance(short_clip, return_state=True)
    np.testing.assert_array_equal(ya, yb)
    for f in sta._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sta, f)),
                                      np.asarray(getattr(stb, f)),
                                      err_msg=f)


@pytest.mark.slow
@pytest.mark.parametrize("name", [
    "snmf_nat", "proposed_is16", "proposed_is16_obj", "snmf",
    "semisupervised", "exemplar", "techwin_rt", "snmf_techwin_rt"])
def test_every_preset_enhances(reference_bases, short_clip, name):
    """E2E smoke across ALL named presets (each mirrors one reference
    settings/*.m file): plan auto-selection, rank tiling, and the full
    enhance path must work for every configuration a reference user could
    select.  (The 'imcra' preset routes to OmlsaEnhancer — covered by
    test_imcra.)"""
    from se_snmf_nat_tpu.config import preset
    cfg = preset(name)
    speech, noise = reference_bases
    sp = speech.tiled_to_rank(cfg.sep.r_x)
    no = noise.tiled_to_rank(cfg.sep.r_d)
    if cfg.sep.b_sep_mode == "Mel":
        b1_x, b1_d = sp.b_mel, no.b_mel
    else:
        b1_x, b1_d = sp.b_dft, no.b_dft
    enh = SnmfEnhancer(cfg, b1_x[:, : cfg.sep.r_x], b1_d[:, : cfg.sep.r_d],
                       sp.b_dft[:, : cfg.sep.r_x], no.b_dft[:, : cfg.sep.r_d],
                       dtype=jnp.float64)
    y = enh.enhance(short_clip)
    assert y.dtype == np.int16 and len(y) > 0
    assert np.all(np.isfinite(y.astype(np.float64)))
    assert np.abs(y.astype(np.int64)).max() > 0
    # RMS must not blow up past the input (enhancement, not amplification)
    rms_in = np.sqrt(np.mean(short_clip[: len(y)].astype(np.float64) ** 2))
    rms_out = np.sqrt(np.mean(y.astype(np.float64) ** 2))
    assert rms_out < 2.0 * rms_in


@pytest.mark.slow
def test_block_adaptive_gap1_and_small_ring(reference_bases, short_clip):
    """Review regressions: (a) blk_gap < 3 must route Q through the
    sequential recurrence path instead of crashing; (b) adapt.m_a smaller
    than the block (more than m_a triggers per block) must keep only the
    newest m_a ring pushes, not scatter-collide."""
    from dataclasses import replace
    cfg = default_config()
    cfg_gap1 = cfg.evolve(blk=replace(cfg.blk, blk_gap=1))
    enh = SnmfEnhancer(cfg_gap1, *_bases4(reference_bases),
                       dtype=jnp.float64, block_adapt=8)
    y = enh.enhance(short_clip)
    assert len(y) > 0 and np.all(np.isfinite(y.astype(np.float64)))
    # gap=1 block plan still matches the gap=1 exact plan closely
    exact = SnmfEnhancer(cfg_gap1, *_bases4(reference_bases),
                         dtype=jnp.float64)
    corr = np.corrcoef(y.astype(float),
                       exact.enhance(short_clip).astype(float))[0, 1]
    assert corr > 0.97, corr

    cfg_small = cfg.evolve(adapt=replace(cfg.adapt, m_a=4))
    blk8 = SnmfEnhancer(cfg_small, *_bases4(reference_bases),
                        dtype=jnp.float64, block_adapt=8)
    y8 = blk8.enhance(short_clip)
    assert np.all(np.isfinite(y8.astype(np.float64)))
    # deterministic: the same call twice gives identical output (a
    # colliding scatter would be nondeterministic)
    np.testing.assert_array_equal(y8, blk8.enhance(short_clip))


def _bases4(reference_bases):
    speech, noise = reference_bases
    return (speech.b_dft, noise.b_dft, speech.b_dft, noise.b_dft)


def test_splice_branch_guard_fires(reference_bases):
    """The retired reference splice/multi-frame branches
    (bnmf_sep_event_RT_IS16.m:85-100) are unreachable in every shipped
    configuration (all 9 settings files pin Splice=0, blk_len_sep=1 — see
    PARITY.md proof); setting either field must hit the contract guard,
    not silently run the single-frame path."""
    from dataclasses import replace

    cfg = default_config()
    for sep_kw in ({"splice": 1}, {"blk_len_sep": 2}):
        bad = cfg.evolve(sep=replace(cfg.sep, **sep_kw))
        with pytest.raises(NotImplementedError):
            _enhancer(bad, reference_bases, jnp.float64)


def test_paired_dispatch_outputs_bit_identical(reference_bases, short_clip):
    """The bench's pair-dispatch program (two B-batches inside one jit —
    bench.py r5) must produce the same bytes as two single dispatches:
    batches are independent, so jit composition may not change values."""
    import jax

    cfg = default_config()
    enh = SnmfEnhancer(cfg, reference_bases[0].b_dft,
                       reference_bases[1].b_dft, reference_bases[0].b_dft,
                       reference_bases[1].b_dft, dtype=jnp.float64,
                       block_adapt=16, frame_bucket=16)
    frames = enh._pad_frames(enh.frames_for(short_clip))
    t_true = enh.frames_for(short_clip).shape[0]
    b = 3
    batch = jnp.asarray(np.stack([frames] * b), jnp.float64)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (b,) + a.shape),
                          enh.initial_state())
    tv = jnp.full((b,), t_true, jnp.int32)

    @jax.jit
    def run_pair(stack, states, win, tv):
        outs = []
        for i in range(2):
            y, _ = enh._block_run_batch(stack[i], states, win, tv)
            outs.append(y)
        return jnp.stack(outs)

    stack = jnp.stack([batch, batch * jnp.float64(1.0001)])
    got = run_pair(stack, states, enh.win, tv)
    for i in range(2):
        want, _ = enh._block_run_batch(stack[i], states, enh.win, tv)
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want))
