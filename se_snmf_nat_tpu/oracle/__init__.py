"""Float64 NumPy oracle — an exact-semantics model of the reference MATLAB
pipeline, used as the ground truth for testing the JAX implementation.

This is NOT the production path: it is sequential, dynamically shaped, and
deliberately mirrors the reference's quirks (legacy rand streams, column
compaction + reordering during adaptation, per-frame solver reseeding) so the
JAX pipeline can be validated against it at tight tolerances, and so the
whole framework can be validated against the reference's committed golden
wavs without a MATLAB installation.
"""

from se_snmf_nat_tpu.oracle.sparse_nmf_np import sparse_nmf_np
from se_snmf_nat_tpu.oracle.engine_np import OracleEngine, init_state
from se_snmf_nat_tpu.oracle.runner_np import enhance_file_oracle, enhance_samples_oracle
from se_snmf_nat_tpu.oracle.imcra_np import ImcraParams, omlsa_imcra_np
from se_snmf_nat_tpu.oracle.ms_np import MsParams, ssubmmse_np, estnoisem_np

__all__ = [
    "sparse_nmf_np",
    "OracleEngine",
    "init_state",
    "enhance_file_oracle",
    "enhance_samples_oracle",
    "ImcraParams",
    "omlsa_imcra_np",
    "MsParams",
    "ssubmmse_np",
    "estnoisem_np",
]
