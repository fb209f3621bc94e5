"""Multi-host initialization and cross-host statistic merging.

The reference is single-process; its only cross-run channel is B_D_u.mat on
disk (SURVEY §5).  This framework's multi-host story:

  * ``init_multihost()`` — jax.distributed.initialize() wrapper (no-op on a
    single process) so campaigns scale to multi-host slices with per-host
    file sharding;
  * ``shard_files_for_host()`` — deterministic round-robin split of a
    campaign's file list across hosts (file-level DP between hosts; each
    host's devices batch utterances);
  * ``merged_dictionary_state()`` — psum/mean-merge of per-shard adapted
    dictionary heads, the in-memory replacement for the reference's
    unlocked B_D_u.mat read-modify-write race.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> dict:
    """Initialize jax.distributed when running multi-process; returns the
    topology facts either way."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def shard_files_for_host(files: list, process_index: int | None = None,
                         process_count: int | None = None) -> list:
    """Round-robin file split (deterministic given sorted input)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return list(files)[pi::pc]


def merged_dictionary_state(states, mesh: Mesh):
    """Mean-merge the adapted dictionary heads of per-shard engine states
    over the mesh 'data' axis; other state fields keep shard-local values
    (they are per-stream recurrences, not statistics).

    states: an EngineState pytree whose leaves carry a leading shard axis
    sharded over 'data'."""
    def merge(head):
        f = jax.shard_map(
            lambda h: jnp.broadcast_to(
                jax.lax.pmean(jnp.mean(h, axis=0, keepdims=True), "data"),
                h.shape),
            mesh=mesh, in_specs=P("data"), out_specs=P("data"),
            check_vma=False)
        return f(head)

    return states._replace(b_d_head=merge(states.b_d_head))
