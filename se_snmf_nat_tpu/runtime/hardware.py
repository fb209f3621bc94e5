"""Accelerator facts the benchmarks divide by, and the compile cache.

``PEAKS`` holds published peak rates keyed by JAX's ``device_kind``.  A
device that is not in the table is an error, never a default: a roofline
share against a guessed peak reads as a measurement and is not one.
"""

from __future__ import annotations

import os
from pathlib import Path

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates (no
# sparsity), at the full 700 W power limit.  float32 is the CUDA-core rate;
# tf32 is what an f32 matmul reaches when XLA lowers it to TF32.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM5, dense",
    },
}

CHECKOUT = Path(__file__).resolve().parents[2]


def peaks(device_kind: str) -> dict:
    """The ``PEAKS`` row of ``device_kind``; raises KeyError when the
    device has none."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def compile_cache_dir() -> Path:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else CHECKOUT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``."""
    import jax

    path = compile_cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
