"""Dictionary training: the JAX re-design of run_basis_train.m.

Feature assembly runs on the host (NumPy); the sparse-NMF factorization —
the offline hot loop (513 x ~72k KL MU iterations, SURVEY §3.4) — runs on
device through nmf/solver.snmf_solve, whose GEMMs map onto matrix units.
Multi-chip training shards the frame axis through
parallel/train_step.make_distributed_train_step.

Pipeline per event class (run_basis_train.m:11-136):
  cache hit?  ->  load R_<R> checkpoint
  else: build training sequence -> features (DFT + mel) -> exemplar column
  sampling -> [full SNMF solve unless exemplar mode] -> column L2
  normalization (+1e-9) -> optional k-means rank reduction -> checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from se_snmf_nat_tpu.config import PipelineConfig
from se_snmf_nat_tpu.io.basis import BasisPair, load_basis, save_basis
from se_snmf_nat_tpu.nmf.solver import SnmfParams, snmf_solve
from se_snmf_nat_tpu.train.dataset import build_training_sequence
from se_snmf_nat_tpu.train.features import TrainingFeatures, training_features
from se_snmf_nat_tpu.train.kmeans import kmeans_reduce
from se_snmf_nat_tpu.utils.matlab_compat import MatlabTwister, matlab_v4_rand_matrix


@dataclass
class BasisTrainResult:
    basis: BasisPair
    a_dft: np.ndarray | None     # final activations (None in exemplar mode)
    a_mel: np.ndarray | None
    n_frames: int
    iters_dft: int = 0
    iters_mel: int = 0


def exemplar_sample_idx(n_frames: int, count: int, seed: int = 1) -> np.ndarray:
    """Deterministic exemplar column sampling.

    Reference: rng('default'); rng(1); randsample(T, cluster_buff*R)
    (run_basis_train.m:80-81).  randsample's internal consumption of the
    twister stream is implementation-defined; this framework fixes the
    scheme to sort-based sampling from the same mt19937ar stream
    ([~, idx] = sort(rand(1, n)); idx(1:k)) — deterministic and seeded, but
    documented as not bit-equal to MATLAB's randsample.
    """
    tw = MatlabTwister(seed)
    u = tw.rand(1, n_frames).reshape(-1)
    return np.argsort(u, kind="stable")[:count]


def _solve_full(v: np.ndarray, w0: np.ndarray, cfg: PipelineConfig,
                dtype) -> tuple[np.ndarray, np.ndarray, int]:
    """Full (W+H) sparse-NMF solve on device; H init from the reference's
    per-solve reseeded legacy stream (sparse_nmf.m:112-134)."""
    r = w0.shape[1]
    h0 = matlab_v4_rand_matrix(r, v.shape[1], cfg.nmf.random_seed)
    params = SnmfParams(
        beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
        flr=1e-9, precision=cfg.runtime.matmul_precision)
    mask = jnp.ones(r, bool)
    res = snmf_solve(jnp.asarray(v, dtype), jnp.asarray(w0, dtype),
                     jnp.asarray(h0, dtype), mask, mask, params,
                     update_w=True, update_h=True)
    return np.asarray(res.w), np.asarray(res.h), int(res.iters)


def _normalize_plus_eps(b: np.ndarray) -> np.ndarray:
    """Column L2 normalize then +1e-9 (run_basis_train.m:112-116)."""
    wn = np.sqrt(np.sum(b * b, axis=0))
    return b / wn + 1e-9


def train_event_basis(
    features: TrainingFeatures, cfg: PipelineConfig, r: int, *,
    dtype=jnp.float32, kmeans_rng: np.random.Generator | None = None,
    exemplar_seed: int = 1,
) -> BasisTrainResult:
    """Train one event class's (DFT, mel) dictionary pair from features.

    ``exemplar_seed``: seed of the exemplar column draw (reference default
    rng(1), run_basis_train.m:80).  Varying it measures the output spread
    the draw itself induces — the envelope that bounds the documented
    non-bit-equality vs MATLAB's randsample (PARITY.md; gated by
    tests/test_train.py::test_exemplar_draw_envelope)."""
    t = features.tf_mag.shape[1]
    count = cfg.train.cluster_buff * r
    if count > t:
        raise ValueError(f"need >= {count} frames, got {t}")
    idx = exemplar_sample_idx(t, count, seed=exemplar_seed)
    b_dft = features.tf_mag[:, idx]
    b_mel = features.tf_mel[:, idx]

    a_dft = a_mel = None
    it_d = it_m = 0
    if not cfg.train.train_exemplar:
        b_dft, a_dft, it_d = _solve_full(features.tf_mag, b_dft, cfg, dtype)
        b_mel, a_mel, it_m = _solve_full(features.tf_mel, b_mel, cfg, dtype)

    b_dft = _normalize_plus_eps(b_dft)
    b_mel = _normalize_plus_eps(b_mel)

    if cfg.train.cluster_buff > 1:
        keep = kmeans_reduce(b_mel, r, rng=kmeans_rng)
        b_dft, b_mel = b_dft[:, keep], b_mel[:, keep]
        if a_dft is not None:
            a_dft, a_mel = a_dft[keep, :], a_mel[keep, :]

    return BasisTrainResult(basis=BasisPair(b_dft=b_dft, b_mel=b_mel),
                            a_dft=a_dft, a_mel=a_mel, n_frames=t,
                            iters_dft=it_d, iters_mel=it_m)


def train_event_basis_cached(
    db_path: str | Path, basis_dir: str | Path, cfg: PipelineConfig, r: int,
    *, dc_freq: float | None = None, vad: bool = False,
    force_retrain: bool = False, dtype=jnp.float32,
    shuffle_rng: np.random.Generator | None = None,
    save_sequence: bool = False,
) -> BasisPair:
    """Cache-aware per-class training (run_basis_train.m:11-12,136-138).

    Checkpoints land at <basis_dir>/R_<r>.npz; a hit short-circuits training
    unless force_retrain.  dc_freq overrides the config's DC zeroing cutoff
    per class (the driver passes per-class DC_freq_set,
    Do_MultiBatch_IS16_20160324_CHiME4.m:95-107).
    """
    basis_dir = Path(basis_dir)
    ckpt = basis_dir / f"R_{r}.npz"
    # The cache key is rank-only, exactly like the reference's
    # R_<R>.mat inside a per-config directory (run_basis_train.m:11-12 —
    # the settings are encoded in basis_dir's name by the caller).  A
    # sidecar records the options so a hit under DIFFERENT options warns
    # instead of silently returning a stale dictionary.
    import json as _json
    opts = {"vad": bool(vad), "dc_freq": dc_freq}
    sidecar = basis_dir / f"R_{r}.opts.json"
    if ckpt.exists() and not force_retrain:
        if sidecar.exists():
            stale = _json.loads(sidecar.read_text())
            if {k: stale.get(k) for k in ("vad", "dc_freq")} != opts:
                import warnings
                warnings.warn(
                    f"{ckpt}: cache hit with different training options "
                    f"(cached {stale}, requested vad={vad} "
                    f"dc_freq={dc_freq}); pass force_retrain/--force to "
                    f"retrain", stacklevel=2)
        return load_basis(ckpt)

    sig = cfg.signal
    dc_bin = (sig.dc_bin if dc_freq is None else
              replace(sig, dc_freq=dc_freq).dc_bin)
    seq, _spec = build_training_sequence(db_path, cfg, vad=vad,
                                         rng=shuffle_rng)
    feats = training_features(seq, cfg, dc_bin=dc_bin)
    result = train_event_basis(feats, cfg, r, dtype=dtype)

    basis_dir.mkdir(parents=True, exist_ok=True)
    save_basis(ckpt, result.basis)
    sidecar.write_text(_json.dumps(opts))
    if save_sequence:
        from se_snmf_nat_tpu.io.wavio import write_enhanced_wav
        write_enhanced_wav(basis_dir / "train_seq.wav", seq, sig.fs)
    return result.basis


def train_event_bases(
    db_paths: list[str | Path], basis_dirs: list[str | Path],
    cfg: PipelineConfig, r: int, *, dc_freqs: list[float] | None = None,
    vad_flags: list[bool] | None = None, **kw,
) -> BasisPair:
    """Multi-class wrapper: train/load each class and concatenate columns
    (run_basis_train.m:5-6,142-143 block layout: class l fills columns
    [l*R, (l+1)*R))."""
    n = len(db_paths)
    dc_freqs = dc_freqs or [None] * n
    vad_flags = vad_flags or [False] * n
    pairs = [
        train_event_basis_cached(db, bd, cfg, r, dc_freq=dc, vad=v, **kw)
        for db, bd, dc, v in zip(db_paths, basis_dirs, dc_freqs, vad_flags)
    ]
    return BasisPair(
        b_dft=np.concatenate([p.b_dft for p in pairs], axis=1),
        b_mel=np.concatenate([p.b_mel for p in pairs], axis=1),
    )
