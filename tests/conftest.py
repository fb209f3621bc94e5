"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
tests exercise multi-device layouts without accelerators, and enable x64 so
oracle-equivalence tests can separate semantic errors from precision.
Tests that need the card are marked ``gpu`` and decide in a fixture."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF = "/root/reference"


@pytest.fixture(scope="session")
def reference_bases():
    from se_snmf_nat_tpu.io.basis import load_reference_speech_noise
    return load_reference_speech_noise(100)


@pytest.fixture(scope="session")
def m03_wav():
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    x, fs = read_wav_int16(f"{REF}/wav/M03_423C0213_STR.CH6.wav")
    return x, fs


@pytest.fixture(scope="session")
def m03_golden():
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    x, fs = read_wav_int16(f"{REF}/wav/M03_423C0213_STR.CH6_out_v3.9_18.wav")
    return x, fs


@pytest.fixture(scope="session")
def lm_wav():
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    x, fs = read_wav_int16(f"{REF}/wav/LM_in.wav")
    return x, fs


@pytest.fixture(scope="session")
def lm_golden():
    from se_snmf_nat_tpu.io.wavio import read_wav_int16
    x, fs = read_wav_int16(f"{REF}/wav/LM_in_out_v3.9_18.wav")
    return x, fs


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
