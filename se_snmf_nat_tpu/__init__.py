"""se_snmf_nat_tpu — sparse-NMF speech-enhancement framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
lordet01/SE_SNMF_NAT reference (GIST Source Separation + Enhancement Engine,
Interspeech-2016 "Local Sparsity Based Online Dictionary Learning for
Environment-Adaptive Speech Enhancement with NMF").

Layer map (accelerator-first, not a port):
  dsp/      — batched STFT/iSTFT, mel filterbank, splicing, smoothing (XLA rfft)
  nmf/      — beta-divergence sparse-NMF multiplicative-update solvers
              (batched, masked, jit-friendly while_loop convergence)
  enhance/  — frame engine (lax.scan), block-sparsity gate, MMSE/Wiener gains,
              IMCRA/OM-LSA baseline
  adapt/    — online noise-dictionary adaptation state + update rules
  stream/   — streaming & offline pipeline facades
  train/    — dictionary training (SNMF / exemplar / DNMF refit / k-means)
  parallel/ — mesh construction, data-parallel sharding, psum stat merges
  oracle/   — float64 NumPy bit-faithful re-implementation of the reference
              semantics (the test oracle; NOT the production path)
  io/       — wav/PCM int16 I/O with MATLAB-compatible quantization, .mat bases
  runtime/  — native (C++) streaming runtime: ring buffers, frame queues
"""

__version__ = "0.1.0"

from se_snmf_nat_tpu.config import PipelineConfig, default_config, preset

__all__ = ["PipelineConfig", "default_config", "preset", "__version__"]
