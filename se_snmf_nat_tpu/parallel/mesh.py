"""Device-mesh and sharding helpers.

The reference has no distribution at all (single MATLAB process; shared
state via .mat files — SURVEY §2.7).  This framework scales two ways:

* data parallelism — utterance batches sharded over the 'data' axis for
  enhancement, spectrogram frames sharded over 'data' for training;
* model parallelism — dictionary columns sharded over 'model' when ranks
  grow (exemplar configs use R=500+; NTF unfoldings can exceed one chip).

Collectives are emitted by GSPMD from NamedSharding annotations; the only
hand-written collective is the psum of sufficient statistics in the
distributed MU trainer (parallel/train_step.py).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: tuple[int, ...] | None = None,
              axes: tuple[str, ...] = ("data", "model"),
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on the 'data' axis, 'model' trivial — the right
    layout for utterance-parallel enhancement.  Multi-host callers pass an
    explicit shape (e.g. (n_hosts*chips//mp, mp)).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axes)


def data_sharding(mesh: Mesh, ndim: int, data_dim: int = 0) -> NamedSharding:
    """Shard dimension ``data_dim`` over 'data', replicate the rest."""
    spec = [None] * ndim
    spec[data_dim] = "data"
    return NamedSharding(mesh, P(*spec))


def model_sharding(mesh: Mesh, ndim: int, model_dim: int) -> NamedSharding:
    spec = [None] * ndim
    spec[model_dim] = "model"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
