"""Compiled-HLO collective audit: what actually crosses the interconnect.

BASELINE.md's scaling target (>=90% efficiency at 2 hosts) needs more
than one host to measure, so the next-best evidence is
assembled here: compile every parallel program the framework ships on a
virtual device mesh, parse the optimized HLO for collective operations,
and report the exact bytes each program moves per step.  Combined with the
measured single-device step times and the interconnect
specs, that yields an analytic scaling estimate that is CHECKABLE — the
collective inventory is read from the compiler's own output, not asserted.

Programs audited (see ``audit_all``):

* DP enhancement batch (the production block-adaptive plan, lanes sharded
  over 'data') — the campaign scale-out path.  Expected: ZERO collectives
  (utterances are independent; the reference's only cross-run coupling,
  B_D_u.mat, is carried per-shard and merged once at the end).
* pmean dictionary merge (``parallel.distributed.merged_dictionary_state``)
  — the in-memory replacement for the reference's unlocked B_D_u.mat
  read-modify-write (/root/reference/src/NTF_sep_event_RT.m:28-38,136-139).
  Expected: ONE all-reduce of the adapted head.
* distributed MU train step (``parallel.train_step``) — psum'd sufficient
  statistics, 2 collectives per MU iteration ((F,R) + (R,)).
* TP activation solve (``parallel.model_shard``) — one (F,N) psum per Λ
  rebuild inside the while loop, plus the per-column cost merge.
* time-sharded enhancement (``parallel.time_shard``) — halo warm-up is
  carried in the INPUT layout, so the hot loop is collective-free.

HLO ops counted: all-reduce, all-gather, reduce-scatter, all-to-all,
collective-permute, collective-broadcast (fusion variants included).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_COLLECTIVE_RE = re.compile(
    r"=\s*(?P<type>\([^)]*\)|[a-z0-9]+\[[0-9,]*\])\S*\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute|collective-broadcast)(?:-start|-done)?\(")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO result type ('f32[64,13]' or a tuple of shapes)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveReport:
    ops: list = field(default_factory=list)   # [{op, bytes, type}]

    @property
    def total_bytes(self) -> int:
        return sum(o["bytes"] for o in self.ops)

    @property
    def count(self) -> int:
        return len(self.ops)

    def summary(self) -> dict:
        by_op: dict[str, dict] = {}
        for o in self.ops:
            e = by_op.setdefault(o["op"], {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += o["bytes"]
        return {"n_collectives": self.count,
                "total_bytes": self.total_bytes, "by_op": by_op}


def collectives_in_hlo(hlo_text: str) -> CollectiveReport:
    """Parse optimized HLO for collective ops and their result sizes.

    `-start`/`-done` async pairs are de-duplicated (the `-done` carries no
    new traffic).  Sizes are the op RESULT bytes — for all-reduce that is
    the full reduced buffer (what each participant receives), the natural
    per-step "wire bytes per device" figure for ring/tree implementations
    up to the 2(k-1)/k factor.
    """
    rep = CollectiveReport()
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue                      # async completion: no new bytes
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        rep.ops.append({"op": m.group("op"),
                        "bytes": _shape_bytes(m.group("type")),
                        "type": m.group("type")})
    return rep


def audit_compiled(jitted_fn, *args) -> CollectiveReport:
    """Lower + compile a jitted callable and audit its optimized HLO."""
    compiled = jitted_fn.lower(*args).compile()
    return collectives_in_hlo(compiled.as_text())


# ---------------------------------------------------------------------------
def audit_all(per_device_batch: int = 2) -> dict:
    """Compile every shipped parallel program on the virtual mesh and
    return the per-step collective-byte table (the SCALING artifact)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.io.basis import load_reference_speech_noise
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    from se_snmf_nat_tpu.parallel.mesh import data_sharding, make_mesh
    from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer

    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev, 1))
    cfg = default_config()
    speech, noise = load_reference_speech_noise(cfg.sep.r_d)
    x, fs = read_wav_int16("/root/reference/wav/M03_423C0213_STR.CH6.wav")
    out: dict[str, dict] = {}

    # --- 1. DP enhancement batch: the PRODUCTION block-adaptive plan.
    # NOTE the dft_matmul dependence (gated in tests/test_collectives.py):
    # with the matmul DFT the program moves only while-loop sync preds
    # (bytes); with jnp.fft, GSPMD cannot shard the FFT over the lane axis
    # and all-gathers the full (B,T,fft) batch to run it replicated —
    # the matmul transform is what makes DP sharding collective-free.
    from se_snmf_nat_tpu.headline import HEADLINE_PLAN
    enh = SnmfEnhancer(cfg, speech.b_dft, noise.b_dft, speech.b_dft,
                       noise.b_dft, dtype=jnp.float32, **HEADLINE_PLAN)
    frames = enh._pad_frames(enh.frames_for(x[: 4 * cfg.signal.frameshift
                                              * 192]))
    b = per_device_batch * n_dev
    batch = jax.device_put(
        jnp.asarray(np.stack([frames] * b), jnp.float32),
        data_sharding(mesh, 3, 0))
    states = jax.tree.map(
        lambda a: jax.device_put(
            jnp.broadcast_to(a, (b,) + a.shape),
            data_sharding(mesh, a.ndim + 1, 0)),
        enh.initial_state())
    tv = jax.device_put(
        jnp.full((b,), frames.shape[0], jnp.int32), data_sharding(mesh, 1, 0))
    rep = audit_compiled(enh._block_run_batch, batch, states, enh.win, tv)
    out["dp_enhance_block_plan"] = {
        **rep.summary(),
        "per": "one 64-utterance batch call",
        "note": "production headline program, lanes sharded over 'data'"}

    # --- 2. pmean dictionary merge
    from se_snmf_nat_tpu.parallel.distributed import merged_dictionary_state
    merge_jit = jax.jit(lambda st: merged_dictionary_state(st, mesh))
    rep = audit_compiled(merge_jit, states)
    out["pmean_dictionary_merge"] = {
        **rep.summary(),
        "per": "one merge per campaign (or per checkpoint interval)"}

    # --- 3. distributed MU train step (n_iter inside one program)
    from se_snmf_nat_tpu.parallel.train_step import (
        make_distributed_train_step)
    f, r, t = 513, 200, 1024
    rng = np.random.default_rng(0)
    step = make_distributed_train_step(mesh, n_iter=4)
    v = jax.device_put(jnp.asarray(rng.random((f, t)) + 0.01),
                       NamedSharding(mesh, P(None, "data")))
    h = jax.device_put(jnp.asarray(rng.random((r, t)) + 0.01),
                       NamedSharding(mesh, P(None, "data")))
    w = jax.device_put(jnp.asarray(rng.random((f, r)) + 0.01),
                       NamedSharding(mesh, P()))
    rep = audit_compiled(step, v, w, h)
    out["train_step_4iter"] = {
        **rep.summary(),
        "per": "bytes are PER LOOP BODY (executed once per MU iteration): "
               "XLA fuses the (F,R)+(R,) psums into one all-reduce",
        "shape": f"F={f} r={r} T={t}"}

    # --- 4. TP activation solve (model axis)
    from se_snmf_nat_tpu.nmf.solver import SnmfParams
    from se_snmf_nat_tpu.parallel import model_shard as ms
    from functools import partial as _partial
    tp_mesh = make_mesh((1, n_dev))
    f2, r2, n2 = 513, 200 * n_dev, 256
    v2 = jax.device_put(jnp.asarray(rng.random((f2, n2)) + 0.01,
                                    jnp.float32),
                        NamedSharding(tp_mesh, P()))
    w2 = jax.device_put(jnp.asarray(rng.random((f2, r2)) + 0.01,
                                    jnp.float32),
                        NamedSharding(tp_mesh, P(None, "model")))
    h2 = jax.device_put(jnp.asarray(rng.random((r2, n2)) + 0.01,
                                    jnp.float32),
                        NamedSharding(tp_mesh, P("model", None)))
    params = SnmfParams(beta=1.0, max_iter=40, conv_eps=0.0,
                        precision="default")
    fn = jax.jit(jax.shard_map(
        _partial(ms._h_solve_local, params=params, axis="model"),
        mesh=tp_mesh,
        in_specs=(P(), P(None, "model"), P("model", None)),
        out_specs=(P(None, "model"), P("model", None), P(), P(), P()),
        check_vma=False))
    rep = audit_compiled(fn, v2, w2, h2)
    out["tp_h_solve"] = {
        **rep.summary(),
        "per": "whole solve program; the (F,N) psum sits INSIDE the "
               "while loop -> executed bytes = bytes x iterations",
        "per_iteration_bytes": f2 * n2 * 4,
        "shape": f"F={f2} R={r2} N={n2} (model axis {n_dev})"}

    # --- 5. time-sharded enhancement (halo in the input layout)
    from se_snmf_nat_tpu.dsp.stft import (
        analysis_frames, overlap_add, synthesis_frames)
    s = cfg.signal
    eng = enh.engine
    state0 = enh.initial_state()
    win = enh.win

    def run_shard(fr):
        fr = fr[0]
        mag, phase = analysis_frames(fr, win, s.fftlength, s.pow, s.dc_bin,
                                     s.nonzerofloor, s.preemph)
        ls = jnp.arange(1, mag.shape[0] + 1, dtype=jnp.int32)
        _, xm = jax.lax.scan(eng.step, state0, (mag, ls))
        of = synthesis_frames(xm, phase, s.framelength, s.fftlength, win,
                              s.pow, s.dc_bin_back, s.overlapscale, s.preemph)
        return overlap_add(of, s.frameshift)[None]

    ts_fn = jax.jit(jax.shard_map(
        run_shard, mesh=mesh, in_specs=(P("data", None, None),),
        out_specs=P("data", None), check_vma=False))
    shard_frames = jax.device_put(
        jnp.asarray(np.stack([frames[:128]] * n_dev), jnp.float32),
        NamedSharding(mesh, P("data", None, None)))
    rep = audit_compiled(ts_fn, shard_frames)
    out["time_sharded_enhance"] = {
        **rep.summary(),
        "per": "one long-utterance call (halo rides the input layout)"}

    return out
