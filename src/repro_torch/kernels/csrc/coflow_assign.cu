// Tau-aware greedy cross-core flow assignment (Alg. 1 lines 5-17) for Hopper.
//
// Replaces the Pallas TPU kernel `_assign_kernel` in
// src/repro/kernels/coflow_assign.py (launched by `coflow_assign_fwd`).
// For each flow (i, j, d) in global pi order and every core k it forms
//   li = (row_load[k,i] + d) * (1/r_k) + (row_tau[k,i] + new) * delta
//   lj = (col_load[k,j] + d) * (1/r_k) + (col_tau[k,j] + new) * delta
//   cand_k = max(bound_k, max(li, lj))
// where `new` is 1 unless (i, j) already carries traffic on core k, takes
// the argmin over k (ties to the lowest k) and commits the flow to that core.
//
// What bounds it on an H100: neither bytes nor operations. The kernel reads
// 12 bytes and writes 4 per flow, and does ~10 fp32 operations per flow and
// core, so the roofline bound is under a microsecond even at 4e5 flows.
// Each choice feeds the next flow's bound, so the chain of flows is
// sequential and its time is F times the latency of one step: a few
// shared-memory reads, a dozen dependent fp32 operations, a five-round warp
// shuffle argmin and the commit.
//
// Design: one CTA of one warp. Lane k owns core k (K <= 32): its bound sits
// in a register and its rows of the row/col load and tau arrays in shared
// memory, so no lane ever touches another core's state and the per-flow
// step needs no block-wide barrier, only warp shuffles. One warp is enough
// for now because the greedy chain is latency-bound; adding warps adds no
// parallelism to a chain. Making the step shorter is later work.
//
// The nonzero bitmap (K * N^2 bits, one bit-row of whole words per core)
// stays in shared memory when it fits beside the loads, and otherwise lives
// in a global scratch buffer that the caller zeroes (N=512, K=8 needs 256 KB,
// more than the 227 KB a block can have).
//
// Numerics: the reference multiplies by a precomputed fp32 `1.0 / rates`
// with separate multiplies and adds. Every operation here is an explicit
// round-to-nearest intrinsic (and the build passes -fmad=false), so no FMA
// contraction and no approximate division can flip a near-tie argmin.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kNzShared>
__global__ void __launch_bounds__(kWarp, 1) coflow_assign_kernel(
    const int* __restrict__ fi, const int* __restrict__ fj,
    const float* __restrict__ sizes, const float* __restrict__ rates,
    float delta, int n_flows, int k_cores, int n_ports, int stride,
    int nz_words_per_core, uint32_t* __restrict__ nz_global,
    int* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int kn = k_cores * stride;
  float* row_load = smem;
  float* col_load = row_load + kn;
  float* row_tau = col_load + kn;
  float* col_tau = row_tau + kn;
  uint32_t* nz = kNzShared ? reinterpret_cast<uint32_t*>(col_tau + kn)
                           : nz_global;

  // State is zeroed on every call (the global bitmap by the caller).
  for (int x = lane; x < 4 * kn; x += kWarp) smem[x] = 0.0f;
  if (kNzShared) {
    for (int w = lane; w < k_cores * nz_words_per_core; w += kWarp) nz[w] = 0u;
  }
  __syncwarp();

  const bool owns_core = lane < k_cores;
  const float inv_rate = owns_core ? __fdiv_rn(1.0f, rates[lane]) : 0.0f;
  float bound = 0.0f;
  const int my_row = lane * stride;
  uint32_t* my_nz = nz + (owns_core ? lane * nz_words_per_core : 0);

  for (int base = 0; base < n_flows; base += kWarp) {
    // One chunk of 32 flows, read coalesced: one flow per lane.
    const int f = base + lane;
    int my_i = 0, my_j = 0;
    float my_d = 0.0f;
    if (f < n_flows) {
      my_i = fi[f];
      my_j = fj[f];
      my_d = sizes[f];
    }
    int my_choice = 0;
    const int n_chunk = min(kWarp, n_flows - base);
    for (int t = 0; t < n_chunk; ++t) {
      const int i = __shfl_sync(kFullMask, my_i, t);
      const int j = __shfl_sync(kFullMask, my_j, t);
      const float d = __shfl_sync(kFullMask, my_d, t);

      float cand = INFINITY;
      float rl = 0.0f, cl = 0.0f, fresh = 0.0f;
      int word = 0;
      uint32_t bit = 0u;
      if (owns_core) {
        rl = row_load[my_row + i];
        cl = col_load[my_row + j];
        const float rt = row_tau[my_row + i];
        const float ct = col_tau[my_row + j];
        const int cell = i * n_ports + j;
        word = cell >> 5;
        bit = 1u << (cell & 31);
        fresh = (my_nz[word] & bit) ? 0.0f : 1.0f;
        const float li = __fadd_rn(__fmul_rn(__fadd_rn(rl, d), inv_rate),
                                   __fmul_rn(__fadd_rn(rt, fresh), delta));
        const float lj = __fadd_rn(__fmul_rn(__fadd_rn(cl, d), inv_rate),
                                   __fmul_rn(__fadd_rn(ct, fresh), delta));
        cand = fmaxf(bound, fmaxf(li, lj));
      }

      // Warp argmin over (cand, lane); ties go to the lower lane. The order
      // is total, so every lane ends with the same winner.
      float best = cand;
      int k_star = lane;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float other = __shfl_xor_sync(kFullMask, best, off);
        const int other_k = __shfl_xor_sync(kFullMask, k_star, off);
        if (other < best || (other == best && other_k < k_star)) {
          best = other;
          k_star = other_k;
        }
      }

      if (lane == k_star) {  // commit: only row i and column j of k* change
        row_load[my_row + i] = __fadd_rn(rl, d);
        col_load[my_row + j] = __fadd_rn(cl, d);
        if (fresh != 0.0f) {
          row_tau[my_row + i] = __fadd_rn(row_tau[my_row + i], 1.0f);
          col_tau[my_row + j] = __fadd_rn(col_tau[my_row + j], 1.0f);
          my_nz[word] |= bit;
        }
        // cand = max(bound, li, lj) is the post-commit bound of k*.
        bound = cand;
      }
      if (lane == t) my_choice = k_star;
      __syncwarp();
    }
    if (f < n_flows) out[f] = my_choice;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). All
// pointers are device pointers; `nz_global` is null when the bitmap fits in
// shared memory, else a zeroed buffer of k_cores * nz_words_per_core words.
extern "C" int coflow_assign_launch(
    const int* fi, const int* fj, const float* sizes, const float* rates,
    float delta, int n_flows, int k_cores, int n_ports, int stride,
    int nz_words_per_core, uint32_t* nz_global, int smem_bytes, int* out,
    cudaStream_t stream) {
  if (nz_global == nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        coflow_assign_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    coflow_assign_kernel<true><<<1, kWarp, smem_bytes, stream>>>(
        fi, fj, sizes, rates, delta, n_flows, k_cores, n_ports, stride,
        nz_words_per_core, nullptr, out);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        coflow_assign_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    coflow_assign_kernel<false><<<1, kWarp, smem_bytes, stream>>>(
        fi, fj, sizes, rates, delta, n_flows, k_cores, n_ports, stride,
        nz_words_per_core, nz_global, out);
  }
  return static_cast<int>(cudaGetLastError());
}
