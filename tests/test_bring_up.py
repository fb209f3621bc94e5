"""What the GPU bring-up rests on, checked on the CPU: seeded inputs,
dictionaries trained from them, the peak table, the compile-cache location,
the headline enhancer on given bases, and chip_smoke.py's refusal to run
without a GPU.  The card-side run itself is ``python chip_smoke.py``."""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.io.basis import BasisPair
from se_snmf_nat_tpu.runtime import hardware
from se_snmf_nat_tpu.runtime.synth import noisy_clip, noisy_clips, synth_speech

REPO = Path(__file__).resolve().parent.parent


def test_seeded_clips_are_deterministic():
    a = noisy_clips(5, 3, 1.0, 2.0)
    b = noisy_clips(5, 3, 1.0, 2.0)
    c = noisy_clips(6, 3, 1.0, 2.0)
    assert all(x.dtype == np.int16 for x in a)
    assert all(16000 <= len(x) <= 32000 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))


def test_seeded_clip_mixes_at_requested_snr():
    noisy, clean = noisy_clip(np.random.default_rng(0), 2.0, snr_db=5.0,
                              kind="nriver", lead_s=0.5)
    lead = 8000
    assert not clean[:lead].any()
    noise = noisy[lead:].astype(np.float64) - clean[lead:]
    snr = 10 * np.log10(np.mean(clean[lead:] ** 2) / np.mean(noise ** 2))
    assert abs(snr - 5.0) < 0.1, snr


def _train_cli(db: Path, out: Path, seed: int, rank: int = 100):
    from se_snmf_nat_tpu.cli import main as cli_main
    from se_snmf_nat_tpu.io.basis import load_basis

    rc = cli_main(["train", "--db", str(db), "--basis-dir", str(out),
                   "--rank", str(rank), "--seed", str(seed)])
    assert rc == 0
    return load_basis(out / f"R_{rank}.npz")


@pytest.fixture
def speech_db(tmp_path):
    from se_snmf_nat_tpu.io.wavio import write_wav_int16

    rng = np.random.default_rng(0)
    db = tmp_path / "speech"
    db.mkdir()
    for i in range(3):
        # files of different lengths, so the shuffled order shapes the
        # training sequence
        x = synth_speech(16000 + 4000 * i, 16000, rng)
        write_wav_int16(db / f"s{i}.wav",
                        np.clip(np.rint(x), -32768, 32767).astype(np.int16),
                        16000)
    return db


def test_seeded_training_gives_nonnegative_bases(speech_db, tmp_path):
    pair = _train_cli(speech_db, tmp_path / "basis", seed=0)
    assert pair.b_dft.shape == (513, 100)
    assert np.isfinite(pair.b_dft).all() and (pair.b_dft >= 0).all()


def test_seeded_training_is_reproducible(speech_db, tmp_path):
    """One seed gives bit-identical dictionaries; the training files'
    shuffle is the only unseeded draw without ``--seed``."""
    a = _train_cli(speech_db, tmp_path / "a", seed=3)
    b = _train_cli(speech_db, tmp_path / "b", seed=3)
    assert np.array_equal(a.b_dft, b.b_dft)
    assert np.array_equal(a.b_mel, b.b_mel)
    # a seed with another file order trains another dictionary, so the
    # equality above is not vacuous
    assert not np.array_equal(np.random.default_rng(3).permutation(3),
                              np.random.default_rng(4).permutation(3))
    c = _train_cli(speech_db, tmp_path / "c", seed=4)
    assert not np.array_equal(a.b_dft, c.b_dft)


def test_peak_table_has_h100_and_refuses_unknown_devices():
    row = hardware.peaks("NVIDIA H100 80GB HBM3")
    assert row["bf16_flops"] == 989e12 and row["tf32_flops"] == 495e12
    assert row["fp32_flops"] == 67e12 and row["hbm_bytes_per_s"] == 3.35e12
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError):
            hardware.peaks(kind)


def test_compile_cache_follows_env_else_checkout(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert hardware.compile_cache_dir() == tmp_path / "c"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert hardware.compile_cache_dir() == REPO / ".jax_cache"


def test_headline_enhancer_accepts_given_bases():
    import jax.numpy as jnp

    from se_snmf_nat_tpu.headline import HEADLINE_PLAN, build_headline_enhancer

    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                     adapt=replace(cfg.adapt, r_a=4, m_a=10))
    rng = np.random.default_rng(0)
    speech = BasisPair(rng.random((513, 8)) + 1e-3, rng.random((64, 8)))
    noise = BasisPair(rng.random((513, 4)) + 1e-3, rng.random((64, 4)))
    enh = build_headline_enhancer(cfg, dtype=jnp.float64,
                                  bases=(speech, noise))
    assert enh.frame_bucket == HEADLINE_PLAN["frame_bucket"]
    x = noisy_clip(np.random.default_rng(1), 1.0)[0].astype(np.float64)
    y = enh.enhance(x)
    assert len(y) == (len(x) // 160 + 1) * 160
    assert np.isfinite(y).all() and np.abs(y).max() > 0


def test_chip_smoke_refuses_to_run_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def gpu():
    """Skips unless an NVIDIA card answers (decided here, at run time)."""
    try:
        found = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                               text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        found = ""
    if "GPU" not in found:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` there")


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_card(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
