"""Hand-written Hopper kernels of the port, each beside its plain version.

  coflow_assign    — the paper's tau-aware greedy cross-core assignment
                     (Alg. 1 lines 5-17); replaces the Pallas kernel
                     ``_assign_kernel``. Two CUDA C++ kernels chosen by the
                     number of cores K: K <= 8 in
                     ``csrc/coflow_assign_sm90.cu`` (the chain in
                     registers), 9 <= K <= 32 in ``csrc/coflow_assign.cu``
                     (one warp, lane k owns core k). ``hazards`` makes the
                     flow streams they are tested on.
  flash_attention  — blocked causal/local GQA attention forward (Sq and
                     Sk may differ; Dh 64, 128 or 256); replaces the Pallas
                     kernel ``_fa_kernel``. Two CUDA C++ kernels chosen by
                     dtype: bf16 in
                     ``csrc/flash_attention_sm90.cu`` (TMA + wgmma), fp32 in
                     ``csrc/flash_attention.cu`` (CUDA cores).

``ref.assign_ref`` is the assignment's fp64 host oracle (numpy), the
third implementation of ``core.engine.cross_check``'s assignment gate.

The public entry points are in ``ops`` (``ops.coflow_assign``,
``ops.flash_attention``); each kernel's
module holds its wrapper, its plain version and its launch count. The CUDA
sources are compiled on first use (``_build``), so importing this package
needs neither ``nvcc`` nor a GPU.
"""
