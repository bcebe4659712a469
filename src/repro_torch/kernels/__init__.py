"""Hand-written Hopper kernels of the port, each beside its plain version.

  coflow_assign    — the paper's tau-aware greedy cross-core assignment
                     (Alg. 1 lines 5-17); replaces the Pallas kernel
                     ``_assign_kernel``. Two CUDA C++ kernels chosen by the
                     number of cores K: K <= 8 in
                     ``csrc/coflow_assign_sm90.cu`` (the chain in
                     registers), K >= 9 in
                     ``csrc/coflow_assign_lanes_sm90.cu`` (lane l owns
                     cores [C*l, C*l + C), C = ceil(K/32); in registers up
                     to K = 256, in memory past it). ``hazards`` makes the
                     flow streams they are tested on.
  flash_attention  — blocked causal/local GQA attention forward (Sq and
                     Sk may differ; Dh 64, 128 or 256); replaces the Pallas
                     kernel ``_fa_kernel``. Two CUDA C++ kernels chosen by
                     dtype: bf16 in
                     ``csrc/flash_attention_sm90.cu`` (TMA + wgmma), fp32 in
                     ``csrc/flash_attention_fp32_sm90.cu`` (a tf32 split
                     pre-pass, then TMA + wgmma in 3xTF32); both include
                     ``csrc/sm90_common.cuh``.

``ref.assign_ref`` is the assignment's fp64 host oracle (numpy), the
third implementation of ``core.engine.cross_check``'s assignment gate.

The public entry points are in ``ops`` (``ops.coflow_assign``,
``ops.flash_attention``); each kernel's
module holds its wrapper, its plain version and its launch count. The CUDA
sources are compiled on first use (``_build``), so importing this package
needs neither ``nvcc`` nor a GPU.
"""
