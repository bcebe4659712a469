// Tau-aware greedy cross-core flow assignment (Alg. 1 lines 5-17) for
// Hopper, 1 <= K <= 8: a chain that touches only registers.
//
// Replaces the Pallas TPU kernel `_assign_kernel` in
// src/repro/kernels/coflow_assign.py (launched by `coflow_assign_fwd`), as
// does the warp kernel in coflow_assign.cu, which stays for 9 <= K <= 32.
// For each flow (i, j, d) in global pi order and every core k it forms
//   li = (row_load[k,i] + d) * (1/r_k) + (row_tau[k,i] + new) * delta
//   lj = (col_load[k,j] + d) * (1/r_k) + (col_tau[k,j] + new) * delta
//   cand_k = max(bound_k, max(li, lj))
// where `new` is 1 unless (i, j) already carries traffic on core k, takes
// the argmin over k (ties to the lowest k) and commits the flow to it.
//
// What bounds it on an H100: the latency of one step, not bytes or
// operations. The roofline bound (16 B a flow at 3.35 TB/s) is under a
// microsecond at 2e5 flows, but each choice feeds the next flow's bound, so
// the flows form one sequential chain. The warp kernel pays about 277 ns
// (548 cycles at 1.98 GHz) a flow on an H100 at 700 W: three broadcast
// shuffles, a store -> __syncwarp -> five dependent shared-memory loads,
// the fp32 arithmetic and a five-round shuffle argmin, all on the chain.
// The chain floor -- the only loop-carried work -- is cand_k -> the argmin
// (ceil(log2 K) levels of compare-select) -> the winner's bound -> the next
// flow's cand_k = max(bound_k, a_k): at K = 3 seven dependent instructions,
// some 35-45 cycles, about 20 ns (derived, not measured).
//
// Design: one CTA of two warps.
//  - Warp 1 (producer) streams the flows through a ring of kStages stages
//    of kChunk flows in shared memory, each with a `full` mbarrier (32
//    arrivals, release) that the consumer waits on (acquire) once a stage.
//    It packs a flow as one int4 (row-state offset, col-state offset, cell
//    i*N+j, size bits), so the consumer spends one 16-byte load a flow and
//    no address math, and it drains the consumer's choices of a stage to
//    global memory after the stage's `done` mbarrier. Plain coalesced loads
//    rather than cp.async: the copy is off the chain either way, and the
//    packing needs the values in registers. No global-memory access sits
//    on the consumer's path (but the bitmap's, when it is global).
//  - Warp 0 (consumer) runs the chain. Every lane holds the K candidates
//    and bounds of all cores in registers (arrays indexed by compile-time k
//    only) and runs the same argmin: ceil(log2 K) levels of compare-select
//    with strict `<`, so ties keep the lower k as the reference's first
//    argmin does. The lanes' copies are one warp instruction stream, so the
//    chain costs what one thread's would and needs no broadcast. The
//    per-core arithmetic of a flow (13 fp32 operations a core) is spread
//    over the lanes instead of run K times by one thread: lane k < K
//    evaluates core k, and K shuffles copy the K results into every lane,
//    one step before the chain needs them.
//  - State per port: row[N][K] of (load, tau) pairs, col[N][K] likewise, so
//    lane k reads its core's pair of a port in one 8-byte load and the warp
//    reads a port's K pairs in one instruction. The nonzero bitmap is one
//    byte per cell whose bit k is core k: one broadcast load gives `new`
//    for every core. It stays in shared memory while it fits (N = 150:
//    22,500 B); otherwise (N = 512: 256 KB) it is a global scratch that the
//    wrapper zeroes. A lane only ever reads the row/col pairs it writes
//    (its core's), and every lane stores the same byte of the bitmap, so no
//    lane depends on another's store.
//  - Software pipeline, three flows deep. At step t (flow t on the chain)
//    the state of flow t+3 is loaded right after t's commit (program order
//    keeps the loads behind its stores) and evaluated at step t+1, so a
//    load has a whole step to land. When flow t+2 is evaluated its state
//    misses two commits, and both are forwarded in registers:
//      flow t's, whose core is known by then: lane k* replaces its loaded
//      load/tau on a shared port by what t committed, and a shared cell's
//      byte gets bit k*;
//      flow t+1's, whose core is not: lane k evaluates t+2 both as loaded
//      (a_k: "t+1 went elsewhere") and, if t+2 shares port i or j with
//      t+1 (12% of the main path's flows, mostly port j), with t+1's values
//      on core k patched in (a'_k: "t+1 went to k"; load + d and
//      tau + new are known for every k before the argmin).
//    After flow t+1's argmin only
//      bound_k* = cand_k*,  cand_k = max(bound_k, k == k* ? a'_k : a_k)
//    are left: selects and a max, no memory. Both forwards are branches
//    that are uniform across the warp, taken only by the flows that share
//    a port. The step is written for two alternating sets of registers
//    (the loop runs steps in pairs), so no value that a load or a shuffle
//    is still producing is copied between steps.
//  - The commit: lane k* stores its load and tau pairs (`tau + new` also
//    when the cell was not new, which leaves it unchanged), every lane
//    stores the cell's byte with bit k* set, lane 0 the choice.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, SM clock 1,980
// MHz): 104.5 ns, 207 cycles a flow at K = 3, N = 150, against the warp
// kernel's 275 ns, 544 cycles. That is some six times the chain floor.
// scripts/chain_ladder.py times copies with parts of the step cut (PERF.md
// has its numbers): the chain with its bookkeeping is a third of the step,
// and the evaluation of the flow two steps ahead about half, though
// nothing on the chain waits for it -- one warp issues in order, so its
// dependent arithmetic and shuffles stall what follows them. What holds
// the kernel back is that latency in one instruction stream, not the chain.
//
// Numerics, as in the warp kernel and the Pallas kernel: every operation is
// an explicit round-to-nearest intrinsic and the build passes -fmad=false,
// with inv_rate = 1/r_k by IEEE division, so the choices are bit-equal to
// the plain version. Sizes below 0 are committed like any other (the
// wrapper never pads); F = 0 is never launched.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;   // flows per ring stage
constexpr int kStages = 4;    // ring stages
constexpr int kRing = kChunk * kStages;
constexpr int kThreads = 64;  // warp 0: the chain; warp 1: the producer
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert((kChunk & (kChunk - 1)) == 0 && (kRing & (kRing - 1)) == 0,
              "ring sizes are powers of two");
static_assert(kChunk >= 4 && kChunk % 2 == 0,
              "the prologue reads flows 0..3 from stage 0; steps go in pairs");

// Shared memory, in this order: the 2 * kStages mbarriers, the flow ring
// (int4 per flow), the choice ring (int per flow), row state, col state,
// and (when it fits) the byte-per-cell nonzero bitmap.
constexpr int kBarBytes = 16 * kStages;
constexpr int kRingBytes = kRing * 16;
constexpr int kOutBytes = kRing * 4;

__host__ __device__ inline int smem_bytes(int k, int n, bool nz_shared) {
  return kBarBytes + kRingBytes + kOutBytes + 2 * n * k * 8 +
         (nz_shared ? n * n : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// of more than 10 s traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

// A flow and, in each lane, its core's state of the flow's two ports.
struct Flow {
  int row, col, cell;
  float d;
  uint32_t nz;  // the cell's byte: bit k set if (i, j) has traffic on core k
  float rl, rt, cl, ct;
};

// The flow on the chain, or the one just committed: its ports and cell,
// its cell's byte after every earlier commit, and in lane k what it commits
// on core k (load + d and tau + new, row and column).
struct Committed {
  int row, col, cell;
  uint32_t nz;
  float rld, rt1, cld, ct1;
};

// A flow one step ahead of the chain, evaluated on this lane's core for
// both outcomes of the flow before it: `b_*`/`a_base` as if that flow went
// elsewhere, `p_*`/`a_hit` as if it went to this core (only when the two
// share a port: `hazard`). a_base[k] and a_hit[k] hold every lane's core.
template <int K>
struct Pending {
  int row, col, cell;
  uint32_t nz;  // the cell's byte after every commit but the previous flow's
  bool hazard, hit_cell;
  float b_rld, b_rt1, b_cld, b_ct1;
  float p_rld, p_rt1, p_cld, p_ct1;
  float a_base[K], a_hit[K];
};

template <bool kNzShared>
__device__ __forceinline__ Flow load_flow(int4 e, const float2* row_s,
                                          const float2* col_s,
                                          const uint8_t* nz, int core) {
  Flow f;
  f.row = e.x;
  f.col = e.y;
  f.cell = e.z;
  f.d = __int_as_float(e.w);
  const float2 r = row_s[e.x + core];
  const float2 c = col_s[e.y + core];
  f.rl = r.x;
  f.rt = r.y;
  f.cl = c.x;
  f.ct = c.y;
  f.nz = nz[e.z];
  return f;
}

// The reference's arithmetic for one core: rld = load + d, rt1 = tau + new
// for the row and the column, and max(li, lj).
__device__ __forceinline__ float cost(float rl, float rt, float cl, float ct,
                                      float d, float fresh, float inv_rate,
                                      float delta, float& rld, float& rt1,
                                      float& cld, float& ct1) {
  rld = __fadd_rn(rl, d);
  rt1 = __fadd_rn(rt, fresh);
  cld = __fadd_rn(cl, d);
  ct1 = __fadd_rn(ct, fresh);
  const float li = __fadd_rn(__fmul_rn(rld, inv_rate), __fmul_rn(rt1, delta));
  const float lj = __fadd_rn(__fmul_rn(cld, inv_rate), __fmul_rn(ct1, delta));
  return fmaxf(li, lj);
}

// Every lane gets lane k's `v` as out[k], k < K.
template <int K>
__device__ __forceinline__ void gather(float (&out)[K], float v) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = __shfl_sync(kFullMask, v, k);
}

// First argmin: a tree of compare-selects; strict `<` keeps the left (lower)
// half on ties, so the lowest k of the minimum wins.
template <int K>
__device__ __forceinline__ int first_argmin(const float (&c)[K]) {
  float v[K];
  int ix[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = c[k];
    ix[k] = k;
  }
#pragma unroll
  for (int w = 1; w < K; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < K; k += 2 * w) {
      if (v[k + w] < v[k]) {
        v[k] = v[k + w];
        ix[k] = ix[k + w];
      }
    }
  }
  return ix[0];
}

template <int K, bool kNzShared>
__global__ void __launch_bounds__(kThreads, 1) coflow_assign_chain_kernel(
    const int* __restrict__ fi, const int* __restrict__ fj,
    const float* __restrict__ sizes, const float* __restrict__ rates,
    float delta, int n_flows, int n_ports, uint8_t* nz_global,
    int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + kBarBytes);
  int* out_ring = reinterpret_cast<int*>(smem + kBarBytes + kRingBytes);
  float2* row_s =
      reinterpret_cast<float2*>(smem + kBarBytes + kRingBytes + kOutBytes);
  float2* col_s = row_s + n_ports * K;
  uint8_t* nz = kNzShared ? reinterpret_cast<uint8_t*>(col_s + n_ports * K)
                          : nz_global;
  const uint32_t full_bar = smem_u32(bars);            // + 8 * stage
  const uint32_t done_bar = smem_u32(bars + kStages);  // + 8 * stage

  // State is zeroed on every call (the global bitmap by the caller), and so
  // is the ring: a slot the producer never fills reads as a dummy flow.
  for (int x = threadIdx.x; x < 2 * n_ports * K; x += kThreads)
    row_s[x] = make_float2(0.0f, 0.0f);
  for (int x = threadIdx.x; x < kRing; x += kThreads)
    ring[x] = make_int4(0, 0, 0, 0);
  if (kNzShared) {
    for (int x = threadIdx.x; x < n_ports * n_ports; x += kThreads) nz[x] = 0;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, kWarp);
      mbar_init(done_bar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (n_flows + kChunk - 1) / kChunk;
  if (threadIdx.x >= kWarp) {
    // ---- producer warp: flows in, choices out ---------------------------
    const int lane = threadIdx.x - kWarp;
    auto drain = [&](int c) {
      const int s = c % kStages;
      mbar_wait(done_bar + 8 * s, (c / kStages) & 1);
      for (int x = lane; x < kChunk; x += kWarp) {
        const int f = c * kChunk + x;
        if (f < n_flows) out[f] = out_ring[s * kChunk + x];
      }
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      if (c >= kStages) drain(c - kStages);  // frees stage s
      for (int x = lane; x < kChunk; x += kWarp) {
        const int f = c * kChunk + x;
        if (f < n_flows) {
          const int i = fi[f], j = fj[f];
          ring[s * kChunk + x] = make_int4(i * K, j * K, i * n_ports + j,
                                           __float_as_int(sizes[f]));
        }
      }
      mbar_arrive(full_bar + 8 * s);
    }
    for (int c = max(0, n_chunks - kStages); c < n_chunks; ++c) drain(c);
    return;
  }

  // ---- consumer warp: the chain -----------------------------------------
  // Past the last flow the ring holds zeros or flows of an earlier round:
  // valid ports, loaded and evaluated but never committed.
  int lane;  // read once: the compiler would re-read threadIdx in the loop
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  const int core = lane < K ? lane : 0;  // lanes >= K mirror core 0, unused
  const uint32_t lane_bit = 1u << core;
  const float inv_rate = __fdiv_rn(1.0f, rates[core]);
  float bound[K], cand[K];
#pragma unroll
  for (int k = 0; k < K; ++k) bound[k] = 0.0f;

  // Evaluate flow `f`, whose state was loaded before the commit of flow
  // `o` (on core ok, known) and misses nothing older, one step ahead of
  // flow `h` (the next on the chain, core unknown): patch o's commit into
  // the loaded state, then evaluate for both outcomes of h.
  auto evaluate = [&](const Flow& f, int ok, const Committed& o,
                      const Committed& h, Pending<K>& q) {
    q.row = f.row;
    q.col = f.col;
    q.cell = f.cell;
    q.nz = f.nz;
    float rl = f.rl, rt = f.rt, cl = f.cl, ct = f.ct;
    const bool o_r = f.row == o.row, o_c = f.col == o.col;
    if (o_r || o_c) {  // uniform across the warp, as every branch below
      if (core == ok) {
        if (o_r) {
          rl = o.rld;
          rt = o.rt1;
        }
        if (o_c) {
          cl = o.cld;
          ct = o.ct1;
        }
      }
      if (o_r && o_c) q.nz |= 1u << ok;
    }
    const float fresh = q.nz & lane_bit ? 0.0f : 1.0f;
    gather<K>(q.a_base, cost(rl, rt, cl, ct, f.d, fresh, inv_rate, delta,
                             q.b_rld, q.b_rt1, q.b_cld, q.b_ct1));
    const bool h_r = f.row == h.row, h_c = f.col == h.col;
    q.hazard = h_r || h_c;
    q.hit_cell = h_r && h_c;
    if (q.hazard) {
      gather<K>(q.a_hit,
                cost(h_r ? h.rld : rl, h_r ? h.rt1 : rt, h_c ? h.cld : cl,
                     h_c ? h.ct1 : ct, f.d, q.hit_cell ? 0.0f : fresh,
                     inv_rate, delta, q.p_rld, q.p_rt1, q.p_cld, q.p_ct1));
    }
  };

  // One step of the chain at flow t. In: `cur` (flow t), `next` (flow t+1
  // evaluated for both outcomes of t), `loaded` (flow t+2 as loaded after
  // flow t-1's commit), `ahead` (flow t+3's ring entry). Out: the same one
  // flow later. The loop below alternates two sets of these registers, so
  // a value that a load or a shuffle is still producing is never copied at
  // the end of a step.
  auto step = [&](int t, const Committed& cur, const Pending<K>& next,
                  const Flow& loaded, const int4& ahead, Committed& cur_out,
                  Pending<K>& next_out, Flow& loaded_out, int4& ahead_out) {
    // 1. the chain: flow t's choice, from registers.
    const int ks = first_argmin<K>(cand);

    // 2. commit flow t on core ks.
    if (lane == ks) {
      row_s[cur.row + ks] = make_float2(cur.rld, cur.rt1);
      col_s[cur.col + ks] = make_float2(cur.cld, cur.ct1);
    }
    nz[cur.cell] = static_cast<uint8_t>(cur.nz | (1u << ks));
    if (lane == 0) out_ring[t & (kRing - 1)] = ks;

    // 3. flow t+3's state, after the commit in program order; it is
    //    evaluated one step later.
    loaded_out = load_flow<kNzShared>(ahead, row_s, col_s, nz, core);
    ahead_out = ring[(t + 4) & (kRing - 1)];

    // 4. flow t+1 takes the outcome ks: the winner's bound, its
    //    candidates, its values and its cell's byte.
    cur_out.row = next.row;
    cur_out.col = next.col;
    cur_out.cell = next.cell;
    cur_out.nz = next.nz;
    cur_out.rld = next.b_rld;
    cur_out.rt1 = next.b_rt1;
    cur_out.cld = next.b_cld;
    cur_out.ct1 = next.b_ct1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float b = k == ks ? cand[k] : bound[k];
      bound[k] = b;
      cand[k] = fmaxf(b, next.a_base[k]);
    }
    if (next.hazard) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == ks) cand[k] = fmaxf(bound[k], next.a_hit[k]);
      }
      if (core == ks) {
        cur_out.rld = next.p_rld;
        cur_out.rt1 = next.p_rt1;
        cur_out.cld = next.p_cld;
        cur_out.ct1 = next.p_ct1;
      }
      if (next.hit_cell) cur_out.nz |= 1u << ks;
    }

    // 5. flow t+2, loaded before flow t's commit, for both outcomes of
    //    flow t+1; its shuffles land while the next step's argmin runs.
    evaluate(loaded, ks, cur, cur_out, next_out);
  };

  mbar_wait(full_bar, 0);
  Committed cur0, cur1;
  Pending<K> next0, next1;
  Flow loaded0, loaded1;
  int4 ahead0, ahead1;
  {
    // Flow 0 on the chain; flow 1 evaluated for both outcomes of flow 0
    // (nothing committed before: no port matches -1); flow 2 as loaded;
    // flow 3's ring entry.
    const Flow f = load_flow<kNzShared>(ring[0], row_s, col_s, nz, core);
    float a_all[K];
    gather<K>(a_all, cost(f.rl, f.rt, f.cl, f.ct, f.d,
                          f.nz & lane_bit ? 0.0f : 1.0f, inv_rate, delta,
                          cur0.rld, cur0.rt1, cur0.cld, cur0.ct1));
    cur0.row = f.row;
    cur0.col = f.col;
    cur0.cell = f.cell;
    cur0.nz = f.nz;
#pragma unroll
    for (int k = 0; k < K; ++k) cand[k] = fmaxf(bound[k], a_all[k]);
    const Committed none = {-1, -1, -1, 0u, 0.0f, 0.0f, 0.0f, 0.0f};
    evaluate(load_flow<kNzShared>(ring[1], row_s, col_s, nz, core), 0, none,
             cur0, next0);
    loaded0 = load_flow<kNzShared>(ring[2], row_s, col_s, nz, core);
    ahead0 = ring[3];
  }

  for (int c = 0; c < n_chunks; ++c) {
    // The loop reads up to 4 flows ahead, into the next stage.
    if (c + 1 < n_chunks) {
      mbar_wait(full_bar + 8 * ((c + 1) % kStages), ((c + 1) / kStages) & 1);
    }
    const int t_end = min(n_flows, (c + 1) * kChunk);
    int t = c * kChunk;
    for (; t + 1 < t_end; t += 2) {
      step(t, cur0, next0, loaded0, ahead0, cur1, next1, loaded1, ahead1);
      step(t + 1, cur1, next1, loaded1, ahead1, cur0, next0, loaded0, ahead0);
    }
    if (t < t_end) {  // an odd last flow (only the last stage can be odd)
      step(t, cur0, next0, loaded0, ahead0, cur1, next1, loaded1, ahead1);
    }
    if (lane == 0) mbar_arrive(done_bar + 8 * (c % kStages));
  }
}

template <int K, bool kNzShared>
int launch(const int* fi, const int* fj, const float* sizes, const float* rates,
           float delta, int n_flows, int n_ports, uint8_t* nz_global,
           int smem, int* out, cudaStream_t stream) {
  auto kernel = coflow_assign_chain_kernel<K, kNzShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, stream>>>(fi, fj, sizes, rates, delta, n_flows,
                                         n_ports, nz_global, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_k(const int* fi, const int* fj, const float* sizes,
             const float* rates, float delta, int n_flows, int n_ports,
             uint8_t* nz_global, int* out, cudaStream_t stream) {
  const bool shared = nz_global == nullptr;
  const int smem = smem_bytes(K, n_ports, shared);
  return shared ? launch<K, true>(fi, fj, sizes, rates, delta, n_flows,
                                  n_ports, nullptr, smem, out, stream)
                : launch<K, false>(fi, fj, sizes, rates, delta, n_flows,
                                   n_ports, nz_global, smem, out, stream);
}

}  // namespace

// Dynamic shared memory of one launch: the wrapper's layout must agree.
extern "C" int coflow_assign_sm90_smem_bytes(int k_cores, int n_ports,
                                             int nz_shared) {
  return smem_bytes(k_cores, n_ports, nz_shared != 0);
}

// Launches the kernel on `stream` and returns cudaGetLastError(), or -1 for
// K outside 1..8. All pointers are device pointers; `nz_global` is null when
// the bitmap lives in shared memory, else a zeroed buffer of n_ports^2 bytes.
extern "C" int coflow_assign_sm90_launch(const int* fi, const int* fj,
                                         const float* sizes, const float* rates,
                                         float delta, int n_flows, int k_cores,
                                         int n_ports, uint8_t* nz_global,
                                         int* out, cudaStream_t stream) {
  switch (k_cores) {
#define CASE_K(K)                                                          \
  case K:                                                                  \
    return launch_k<K>(fi, fj, sizes, rates, delta, n_flows, n_ports,      \
                       nz_global, out, stream);
    CASE_K(1) CASE_K(2) CASE_K(3) CASE_K(4) CASE_K(5) CASE_K(6) CASE_K(7)
    CASE_K(8)
#undef CASE_K
    default:
      return -1;
  }
}
