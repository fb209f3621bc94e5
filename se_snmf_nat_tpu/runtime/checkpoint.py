"""Engine-state checkpointing.

Reference equivalents:
  * B_D_u.mat — the adapted noise dictionary persisted across utterances
    (src/NTF_sep_event_RT.m:28-38,136-139; deleted per noise condition by
    the campaign driver, Do_MultiBatch_IS16_20160324_CHiME4.m:193);
  * the streaming resume structs of ssubmmse/estnoisem.

Here the WHOLE EngineState pytree checkpoints (not just the dictionary), so
a resumed stream is bit-identical to an uninterrupted one — the reference
only persisted B_DFT_d/B_Mel_d and silently reset the rings.  Format is
.npz (atomic tmp+rename to fix the reference's unlocked read/write race,
SURVEY §5 'Race detection').
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from se_snmf_nat_tpu.enhance.state import EngineState


def _np_savable(a) -> np.ndarray:
    """np.savez has no bfloat16: it degrades to void '|V2' and neither load
    path can read it back.  Store bf16 fields as float32 (exact; the load
    paths cast to the requested dtype anyway)."""
    a = np.asarray(a)
    if a.dtype.kind == "V":   # ml_dtypes.bfloat16 registers as void
        a = a.astype(np.float32)
    return a


def save_engine_state(path: str | Path, state: EngineState) -> None:
    path = Path(path)
    tmp = path.with_name(path.stem + ".tmp.npz")  # savez appends .npz
    np.savez_compressed(
        tmp, **{f: _np_savable(getattr(state, f)) for f in state._fields})
    os.replace(tmp, path)


def load_engine_state(path: str | Path, dtype=jnp.float32) -> EngineState:
    with np.load(str(path)) as z:
        kw = {}
        for f in EngineState._fields:
            if f not in z.files:
                continue        # fields added later fall to their class
            a = z[f]            # defaults (adapt_on, r4) — old checkpoints
            if a.dtype.kind == "f":   # stay loadable
                kw[f] = jnp.asarray(a, dtype)
            else:
                kw[f] = jnp.asarray(a)
        return EngineState(**kw)


def save_adapted_dictionary(path: str | Path, state: EngineState) -> None:
    """B_D_u.mat-equivalent: persist only the adapted noise-dictionary head
    (what the reference saves, NTF_sep_event_RT.m:136-139)."""
    path = Path(path)
    tmp = path.with_name(path.stem + ".tmp.npz")  # savez appends .npz
    np.savez_compressed(tmp, b_d_head=_np_savable(state.b_d_head))
    os.replace(tmp, path)


def load_adapted_dictionary(path: str | Path,
                            state: EngineState,
                            dtype=jnp.float32) -> EngineState:
    """Seed a fresh state's dictionary head from a persisted checkpoint
    (NTF_sep_event_RT.m:28-38 try/catch load — missing file = fresh)."""
    path = Path(path)
    if not path.exists():
        return state
    with np.load(str(path)) as z:
        return state._replace(b_d_head=jnp.asarray(z["b_d_head"], dtype))


# ---------------------------------------------------------------------------
# Orbax backend — sharded/async checkpointing for multi-host runs, where a
# plain host-local .npz would race across processes.  Same pytree contents.
# ---------------------------------------------------------------------------

def save_engine_state_orbax(path: str | Path, state: EngineState) -> None:
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(Path(path).absolute(), dict(state._asdict()), force=True)


def load_engine_state_orbax(path: str | Path,
                            template: EngineState) -> EngineState:
    import orbax.checkpoint as ocp

    p = Path(path).absolute()
    tpl = dict(template._asdict())
    # The checkpoint's OWN item names decide the restore template: fields
    # added to EngineState after a checkpoint was written (adapt_on, r4)
    # restore from the template instead (mirrors load_engine_state's
    # skip-missing npz behavior) without per-field hardcoding, and a
    # genuinely corrupt checkpoint surfaces its real restore error rather
    # than a masked template-mismatch retry.
    with ocp.PyTreeCheckpointer() as meta_reader:
        stored = set(meta_reader.metadata(p).item_metadata.tree.keys())
    legacy = {k: v for k, v in tpl.items() if k in stored}
    with ocp.StandardCheckpointer() as ckptr:
        restored = {**tpl, **ckptr.restore(p, legacy)}
    return EngineState(**restored)


# ---------------------------------------------------------------------------
# Multichannel streaming state (multichannel/streaming.PmwfStreamState) —
# same atomic-npz treatment as EngineState, so an interrupted multichannel
# stream resumes bit-identically.
# ---------------------------------------------------------------------------

def save_pmwf_state(path: str | Path, state) -> None:
    path = Path(path)
    tmp = path.with_name(path.stem + ".tmp.npz")
    np.savez_compressed(
        tmp, **{f: np.asarray(getattr(state, f)) for f in state._fields})
    os.replace(tmp, path)


def load_pmwf_state(path: str | Path, dtype=jnp.float32):
    from se_snmf_nat_tpu.multichannel.streaming import PmwfStreamState
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    with np.load(str(path)) as z:
        return PmwfStreamState(**{
            f: jnp.asarray(z[f], cdtype) if z[f].dtype.kind == "c"
            else jnp.asarray(z[f]) for f in PmwfStreamState._fields})
