// Tau-aware greedy cross-core flow assignment (Alg. 1 lines 5-17) for
// Hopper, K >= 9: each lane of one warp owns C = ceil(K/32) cores.
//
// Replaces the Pallas TPU kernel `_assign_kernel` in
// src/repro/kernels/coflow_assign.py (launched by `coflow_assign_fwd`) for
// more than eight cores, as the chain kernel (coflow_assign_sm90.cu) does
// for K <= 8. For each flow (i, j, d) in global pi order and every core k
// it forms
//   li = (row_load[k,i] + d) * (1/r_k) + (row_tau[k,i] + new) * delta
//   lj = (col_load[k,j] + d) * (1/r_k) + (col_tau[k,j] + new) * delta
//   cand_k = max(bound_k, max(li, lj))
// where `new` is 1 unless (i, j) already carries traffic on core k, takes
// the argmin over k (ties to the lowest k) and commits the flow to it.
//
// What bounds it on an H100: the latency of one step, as in the chain
// kernel. Each choice feeds the next flow's bound, so the flows form one
// sequential chain; the roofline bound (16 B a flow at 3.35 TB/s) is under
// a microsecond at 2e5 flows. So the design keeps cross-lane traffic, memory
// and branches off the chain.
//
// Design: the chain kernel's CTA of two warps, its flow ring and its
// three-deep software pipeline, with the cores spread over the lanes.
//  - Warp 1 (producer) streams the flows through a ring of kStages stages
//    of kChunk flows, a `full` mbarrier a stage, packing a flow as one int4
//    (row-state offset, col-state offset, bitmap word offset, size bits),
//    and drains the choices of a stage after its `done` mbarrier. No
//    global-memory access sits on the consumer's path but the state's,
//    when it is global.
//  - Ownership: lane l owns the C contiguous cores [C*l, C*l + C); cores
//    past K are padding whose bound is +inf, so they never win. A lane keeps
//    its cores' bounds and candidates in registers and evaluates only its
//    own cores (13 fp32 operations a core), so nothing crosses lanes but
//    the argmin, and K is not bounded by the warp's 32 lanes.
//  - The argmin, in three warp instructions: each lane takes the first
//    argmin of its C candidates (a compare-select tree, strict `<`). Every
//    candidate is >= +0 and never NaN (each evaluation adds +0, off the
//    chain, which turns a -0 into +0), so the order of the bits as unsigned
//    integers is the order of the floats. Then
//      1. __reduce_min_sync (redux.sync.min.u32) gives every lane the least
//         bits over the warp;
//      2. __ballot_sync marks the lanes whose minimum has those bits;
//      3. a lane wins when its bit is the lowest one set (a mask of the
//         lanes up to it; the lowest set bit, __ffs, without its latency).
//    Cores are contiguous per lane, so the lowest lane's local argmin is
//    the lowest k of the minimum: the reference's first argmin. No shuffle
//    is needed: only the winning lane needs its local index.
//  - State: row[N] and col[N] each hold C planes of 32 (load, tau) pairs a
//    port, core C*l + c at plane c, lane l, so lane l reads its cores' pairs
//    of a port in C loads that the warp makes without a bank conflict. The
//    nonzero bitmap holds C words a cell, core C*l + c at bit l of word c:
//    every lane loads the same C words (a broadcast) and tests its bit.
//    Each lane tracks its own bits of the flows in flight (forwarded like
//    the pairs), so at a commit a ballot of them gives every lane the
//    cell's new words and every lane stores them: a lane only ever reads
//    the pairs it writes and the words it stores itself, so no lane
//    depends on another's store, and no atomic is needed. The state
//    stays in shared memory while it fits beside the ring, then the bitmap
//    too; what does not fit (the state at N = 512, the bitmap at K = 64,
//    N = 150) is a global scratch that the wrapper zeroes, L2-resident at
//    these sizes.
//  - Software pipeline, three flows deep, as in the chain kernel. At step t
//    the state of flow t+3 is loaded right after t's commit and evaluated
//    at step t+1. When flow t+2 is evaluated its state misses two commits,
//    both forwarded in registers: flow t's, whose winner is known (the
//    winning lane patches its core's loaded pairs on a shared port and
//    clears the core's `new` on a shared cell), and flow t+1's, whose is
//    not (each lane evaluates t+2 as loaded, a_c, and, if t+2 shares a port
//    with t+1, with t+1's values on its core c patched in, a'_c). After
//    t+1's argmin only
//      bound_k* = cand_k*,  cand_c = max(bound_c, c == k* ? a'_c : a_c)
//    are left. The step is written for two alternating sets of registers.
//
// The chain floor (the loop-carried path, derived, not measured): the max
// that forms cand_c -> 2 per level of the local argmin tree (ceil(log2 C)
// levels) -> redux.sync -> the compare -> the ballot -> the mask -> the
// compare that says this lane won -> the winner's bound select (-> the
// next flow's max): 2 ceil(log2 C) + 7 dependent instructions, 35 cycles at
// K <= 32 counted at 5 cycles each, as the chain kernel's floor is
// (redux.sync's latency is not published; it is counted as the others).
//
// Measured (scripts/chip_lanes.py on an H100 80GB HBM3 at 700 W, SM clock
// 1,980 MHz, F = 191,551, N = 150): 120.2 ns, 238 cycles a flow at K = 3,
// 16 and 32, against 570 / 582 for the warp kernel it replaced at K = 16 /
// 32 and 205 for the chain kernel at K = 3; some seven times the floor.
// At K = 64 (C = 2, the bitmap global) about 514 cycles a flow.
//
// Past K = 256 (C > kMaxPerLane) a lane's cores no longer fit in its
// registers, and `coflow_assign_lanes_wide_kernel` takes over: the same
// CTA, producer, ring, state layout and argmin (a lane's first argmin,
// then redux.sync, the ballot and the lowest set bit), but no pipeline.
// Each lane's cores' bound and 1/r_k live in shared memory (8 B a core,
// 4 KB at K = 512; at the end of the global state scratch where even that
// does not fit), and for each flow the lane loads and evaluates its C
// cores in a loop, the winning lane commits (its pairs, its bound, its
// bit of the cell's word) and a __syncwarp orders the commit before the
// next flow's loads. No configuration of the repository has more than 16
// cores, so this path is written to be right, not fast.
//
// Numerics, as in the chain kernel and the Pallas kernel: every operation
// is an explicit round-to-nearest intrinsic and the build passes
// -fmad=false, with inv_rate = 1/r_k by IEEE division, so the choices are
// bit-equal to the plain version. F = 0 is never launched.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;      // flows per ring stage
constexpr int kStages = 4;       // ring stages
constexpr int kRing = kChunk * kStages;
constexpr int kThreads = 64;     // warp 0: the chain; warp 1: the producer
constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;   // cores a lane holds in registers
constexpr int kSmemLimit = 232448;  // the shared memory a block may use
constexpr unsigned kFullMask = 0xffffffffu;
static_assert((kChunk & (kChunk - 1)) == 0 && (kRing & (kRing - 1)) == 0,
              "ring sizes are powers of two");
static_assert(kChunk >= 4 && kChunk % 2 == 0,
              "the prologue reads flows 0..3 from stage 0; steps go in pairs");

// Shared memory, in this order: the 2 * kStages mbarriers, the flow ring
// (int4 per flow), the choice ring (int per flow), the slots the losing
// lanes store to (two float2 and an int a lane), then while they fit the
// row and col state (C * 32 float2 a port each) and the bitmap (C words a
// cell).
constexpr int kBarBytes = 16 * kStages;
constexpr int kRingBytes = kRing * 16;
constexpr int kOutBytes = kRing * 4;
constexpr int kDummyBytes = kWarp * (8 + 8 + 4);

__host__ __device__ inline long long state_bytes(int c, int n) {
  return 2LL * n * c * kWarp * 8;
}

__host__ __device__ inline long long nz_bytes(int c, int n) {
  return 4LL * c * n * n;
}

// Past kMaxPerLane cores a lane: each core's (bound, 1/r) pair, in shared
// memory after the slots while it fits, else after the global state.
__host__ __device__ inline long long cores_bytes(int c) {
  return c > kMaxPerLane ? 8LL * c * kWarp : 0;
}

__host__ __device__ inline bool cores_shared(int c) {
  return kBarBytes + kRingBytes + kOutBytes + kDummyBytes + cores_bytes(c) <=
         kSmemLimit;
}

__host__ __device__ inline long long smem_bytes(int c, int n,
                                                bool state_shared,
                                                bool nz_shared) {
  return kBarBytes + kRingBytes + kOutBytes + kDummyBytes +
         (cores_shared(c) ? cores_bytes(c) : 0) +
         (state_shared ? state_bytes(c, n) : 0) +
         (nz_shared ? nz_bytes(c, n) : 0);
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

// The producer warp: flows in, choices out. It packs flow f as one int4
// (row-state offset, col-state offset, bitmap word offset, size bits) into
// stage f / kChunk % kStages of the ring, and copies a stage's choices out
// after its `done` mbarrier.
__device__ __forceinline__ void produce(const int* __restrict__ fi,
                                        const int* __restrict__ fj,
                                        const float* __restrict__ sizes,
                                        int n_flows, int n_ports, int c_lane,
                                        int4* ring, const int* out_ring,
                                        uint32_t full_bar, uint32_t done_bar,
                                        int* __restrict__ out) {
  const int lane = threadIdx.x - kWarp;
  const int plane = c_lane * kWarp;
  const int n_chunks = (n_flows + kChunk - 1) / kChunk;
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
        ring[s * kChunk + x] = make_int4(i * plane, j * plane,
                                         (i * n_ports + j) * c_lane,
                                         __float_as_int(sizes[f]));
      }
    }
    mbar_arrive(full_bar + 8 * s);
  }
  for (int c = max(0, n_chunks - kStages); c < n_chunks; ++c) drain(c);
}

// A flow and, in each lane, its cores' state of the flow's two ports.
template <int C>
struct Flow {
  int row, col, cell;
  float d;
  uint32_t fresh;  // bit c: (i, j) carries no traffic on this lane's core c
  float rl[C], rt[C], cl[C], ct[C];
};

// The flow on the chain, or the one just committed: its ports and bitmap
// words, whether its cell is new on each of this lane's cores after every
// earlier commit, and for each of this lane's cores c what it commits there
// (load + d and tau + new, row and column).
template <int C>
struct Committed {
  int row, col, cell;
  uint32_t fresh;
  float rld[C], rt1[C], cld[C], ct1[C];
};

// A flow one step ahead of the chain, evaluated on this lane's cores for
// both outcomes of the flow before it: `b_*`/`a_base` as if that flow went
// elsewhere, `p_*`/`a_hit` as if it went to core c (only when the two
// share a port: `hazard`).
template <int C>
struct Pending {
  int row, col, cell;
  uint32_t fresh;  // after every commit but the previous flow's
  bool hazard, hit_cell;
  float b_rld[C], b_rt1[C], b_cld[C], b_ct1[C];
  float p_rld[C], p_rt1[C], p_cld[C], p_ct1[C];
  float a_base[C], a_hit[C];
};

template <int C, bool kNzShared>
__device__ __forceinline__ Flow<C> load_flow(int4 e, const float2* row_s,
                                             const float2* col_s,
                                             const uint32_t* nz, int lane) {
  Flow<C> f;
  f.row = e.x;
  f.col = e.y;
  f.cell = e.z;
  f.d = __int_as_float(e.w);
  f.fresh = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float2 r = row_s[e.x + c * kWarp + lane];
    const float2 q = col_s[e.y + c * kWarp + lane];
    f.rl[c] = r.x;
    f.rt[c] = r.y;
    f.cl[c] = q.x;
    f.ct[c] = q.y;
    f.fresh |= ((~nz[e.z + c] >> lane) & 1u) << c;
  }
  return f;
}

// The reference's arithmetic for one core: rld = load + d, rt1 = tau + new
// for the row and the column, and max(li, lj) + 0, which turns a -0 into
// +0 (so every bound and candidate is +0 or more, off the chain).
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
  return __fadd_rn(fmaxf(li, lj), 0.0f);
}

__device__ __forceinline__ float fresh_of(uint32_t fresh, int c) {
  return (fresh >> c) & 1u ? 1.0f : 0.0f;
}

// First argmin of this lane's candidates: a tree of compare-selects; strict
// `<` keeps the left (lower) half on ties. Returns the index, the minimum
// in `best`.
template <int C>
__device__ __forceinline__ int first_argmin(const float (&v_in)[C],
                                            float& best) {
  float v[C];
  int ix[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = v_in[c];
    ix[c] = c;
  }
#pragma unroll
  for (int w = 1; w < C; w *= 2) {
#pragma unroll
    for (int c = 0; c + w < C; c += 2 * w) {
      if (v[c + w] < v[c]) {
        v[c] = v[c + w];
        ix[c] = ix[c + w];
      }
    }
  }
  best = v[0];
  return ix[0];
}

template <int C, bool kStateShared, bool kNzShared>
__global__ void __launch_bounds__(kThreads, 1) coflow_assign_lanes_kernel(
    const int* __restrict__ fi, const int* __restrict__ fj,
    const float* __restrict__ sizes, const float* __restrict__ rates,
    float delta, int n_flows, int k_cores, int n_ports, float2* state_global,
    uint32_t* nz_global, int* __restrict__ out) {
  static_assert(kStateShared || !kNzShared,
                "the bitmap goes to shared memory only after the state");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + kBarBytes);
  int* out_ring = reinterpret_cast<int*>(smem + kBarBytes + kRingBytes);
  float2* dummy_pairs =
      reinterpret_cast<float2*>(smem + kBarBytes + kRingBytes + kOutBytes);
  int* dummy_out = reinterpret_cast<int*>(dummy_pairs + 2 * kWarp);
  unsigned char* tail =
      smem + kBarBytes + kRingBytes + kOutBytes + kDummyBytes;
  const int plane = C * kWarp;  // (load, tau) pairs a port
  float2* row_s =
      kStateShared ? reinterpret_cast<float2*>(tail) : state_global;
  float2* col_s = row_s + n_ports * plane;
  uint32_t* nz = kNzShared ? reinterpret_cast<uint32_t*>(col_s + n_ports * plane)
                           : nz_global;
  const uint32_t full_bar = smem_u32(bars);            // + 8 * stage
  const uint32_t done_bar = smem_u32(bars + kStages);  // + 8 * stage

  // State is zeroed on every call (global state by the caller), and so is
  // the ring: a slot the producer never fills reads as a dummy flow.
  if (kStateShared) {
    for (int x = threadIdx.x; x < 2 * n_ports * plane; x += kThreads)
      row_s[x] = make_float2(0.0f, 0.0f);
  }
  if (kNzShared) {
    for (int x = threadIdx.x; x < n_ports * n_ports * C; x += kThreads)
      nz[x] = 0u;
  }
  for (int x = threadIdx.x; x < kRing; x += kThreads)
    ring[x] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, kWarp);
      mbar_init(done_bar + 8 * s, kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (n_flows + kChunk - 1) / kChunk;
  if (threadIdx.x >= kWarp) {
    produce(fi, fj, sizes, n_flows, n_ports, C, ring, out_ring, full_bar,
            done_bar, out);
    return;
  }

  // ---- consumer warp: the chain -----------------------------------------
  // Past the last flow the ring holds zeros or flows of an earlier round:
  // valid ports, loaded and evaluated but never committed.
  int lane;  // read once: the compiler would re-read threadIdx in the loop
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  float inv_rate[C], bound[C], cand[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = C * lane + c;
    const bool owned = k < k_cores;
    inv_rate[c] = __fdiv_rn(1.0f, owned ? rates[k] : 1.0f);
    bound[c] = owned ? 0.0f : INFINITY;  // padding never wins
  }

  // Whether this lane wins the flow on the chain: it holds the least bits
  // and no lower lane does. `lc` is this lane's local argmin, the winner's
  // core C * lane + lc.
  const uint32_t lane_bit = 1u << lane;
  const uint32_t lanes_to_mine = lane_bit | (lane_bit - 1u);
  auto choose = [&](int& lc) -> bool {
    float best;
    lc = first_argmin<C>(cand, best);
    const uint32_t bits = __float_as_uint(best);
    const uint32_t least = __reduce_min_sync(kFullMask, bits);
    const uint32_t tied = __ballot_sync(kFullMask, bits == least);
    return (tied & lanes_to_mine) == lane_bit;
  };

  // Evaluate flow `f`, whose state was loaded before the commit of flow `o`
  // (won by this lane's core `oc` if `o_won`) and misses nothing older, one
  // step ahead of flow `h` (the next on the chain, core unknown): patch o's
  // commit into the loaded state, then evaluate for both outcomes of h.
  auto evaluate = [&](const Flow<C>& f, bool o_won, int oc,
                      const Committed<C>& o, const Committed<C>& h,
                      Pending<C>& q) {
    q.row = f.row;
    q.col = f.col;
    q.cell = f.cell;
    float rl[C], rt[C], cl[C], ct[C];
    uint32_t fresh = f.fresh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      rl[c] = f.rl[c];
      rt[c] = f.rt[c];
      cl[c] = f.cl[c];
      ct[c] = f.ct[c];
    }
    const bool o_r = f.row == o.row, o_c = f.col == o.col;
    if (o_r || o_c) {  // uniform across the warp, as every branch below
      if (o_won) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c == oc) {
            if (o_r) {
              rl[c] = o.rld[c];
              rt[c] = o.rt1[c];
            }
            if (o_c) {
              cl[c] = o.cld[c];
              ct[c] = o.ct1[c];
            }
          }
        }
        if (o_r && o_c) fresh &= ~(1u << oc);
      }
    }
    q.fresh = fresh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q.a_base[c] = cost(rl[c], rt[c], cl[c], ct[c], f.d, fresh_of(fresh, c),
                         inv_rate[c], delta, q.b_rld[c], q.b_rt1[c],
                         q.b_cld[c], q.b_ct1[c]);
    }
    const bool h_r = f.row == h.row, h_c = f.col == h.col;
    q.hazard = h_r || h_c;
    q.hit_cell = h_r && h_c;
    if (q.hazard) {
      const bool hit_cell = q.hit_cell;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        q.a_hit[c] = cost(h_r ? h.rld[c] : rl[c], h_r ? h.rt1[c] : rt[c],
                          h_c ? h.cld[c] : cl[c], h_c ? h.ct1[c] : ct[c],
                          f.d, hit_cell ? 0.0f : fresh_of(fresh, c),
                          inv_rate[c], delta, q.p_rld[c], q.p_rt1[c],
                          q.p_cld[c], q.p_ct1[c]);
      }
    }
  };

  // One step of the chain at flow t. In: `cur` (flow t), `next` (flow t+1
  // evaluated for both outcomes of t), `loaded` (flow t+2 as loaded after
  // flow t-1's commit), `ahead` (flow t+3's ring entry). Out: the same one
  // flow later, in the other set of registers.
  auto step = [&](int t, const Committed<C>& cur, const Pending<C>& next,
                  const Flow<C>& loaded, const int4& ahead,
                  Committed<C>& cur_out, Pending<C>& next_out,
                  Flow<C>& loaded_out, int4& ahead_out) {
    // 1. the chain: flow t's winning lane, from registers and three warp
    //    instructions.
    int lc;
    const bool won = choose(lc);

    // 2. commit flow t on core C * lane + lc of the winning lane: it stores
    //    its pairs and the choice (while the state is shared, every lane
    //    stores, the losers to slots of their own, so the commit is no
    //    divergent branch); every lane stores the same words of the cell's
    //    bitmap, which a ballot of each lane's own bits gives (so every
    //    lane reads back its own store, and no lane's bit is stale).
    {
      float rld = cur.rld[0], rt1 = cur.rt1[0], cld = cur.cld[0],
            ct1 = cur.ct1[0];
#pragma unroll
      for (int c = 1; c < C; ++c) {
        if (lc == c) {
          rld = cur.rld[c];
          rt1 = cur.rt1[c];
          cld = cur.cld[c];
          ct1 = cur.ct1[c];
        }
      }
      if (kStateShared) {  // no branch: the losers store to their slots
        float2* rdst = won ? row_s + cur.row + lc * kWarp + lane
                           : dummy_pairs + lane;
        float2* cdst = won ? col_s + cur.col + lc * kWarp + lane
                           : dummy_pairs + kWarp + lane;
        int* odst = won ? out_ring + (t & (kRing - 1)) : dummy_out + lane;
        *rdst = make_float2(rld, rt1);
        *cdst = make_float2(cld, ct1);
        *odst = C * lane + lc;
      } else if (won) {
        row_s[cur.row + lc * kWarp + lane] = make_float2(rld, rt1);
        col_s[cur.col + lc * kWarp + lane] = make_float2(cld, ct1);
        out_ring[t & (kRing - 1)] = C * lane + lc;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool used = !((cur.fresh >> c) & 1u) || (won && lc == c);
      nz[cur.cell + c] = __ballot_sync(kFullMask, used);
    }

    // 3. flow t+3's state, after the commit in program order; it is
    //    evaluated one step later.
    loaded_out = load_flow<C, kNzShared>(ahead, row_s, col_s, nz, lane);
    ahead_out = ring[(t + 4) & (kRing - 1)];

    // 4. flow t+1 takes the outcome: the winner's bound, the candidates,
    //    the values it commits.
    cur_out.row = next.row;
    cur_out.col = next.col;
    cur_out.cell = next.cell;
    cur_out.fresh = next.fresh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float b = won && lc == c ? cand[c] : bound[c];
      bound[c] = b;
      cand[c] = fmaxf(b, next.a_base[c]);
      cur_out.rld[c] = next.b_rld[c];
      cur_out.rt1[c] = next.b_rt1[c];
      cur_out.cld[c] = next.b_cld[c];
      cur_out.ct1[c] = next.b_ct1[c];
    }
    if (next.hazard) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (won && lc == c) {
          cand[c] = fmaxf(bound[c], next.a_hit[c]);
          cur_out.rld[c] = next.p_rld[c];
          cur_out.rt1[c] = next.p_rt1[c];
          cur_out.cld[c] = next.p_cld[c];
          cur_out.ct1[c] = next.p_ct1[c];
        }
      }
      if (next.hit_cell && won) cur_out.fresh &= ~(1u << lc);
    }

    // 5. flow t+2, loaded before flow t's commit, for both outcomes of
    //    flow t+1.
    evaluate(loaded, won, lc, cur, cur_out, next_out);
  };

  mbar_wait(full_bar, 0);
  Committed<C> cur0, cur1;
  Pending<C> next0, next1;
  Flow<C> loaded0, loaded1;
  int4 ahead0, ahead1;
  {
    // Flow 0 on the chain; flow 1 evaluated for both outcomes of flow 0
    // (nothing committed before: no port matches -1); flow 2 as loaded;
    // flow 3's ring entry.
    const Flow<C> f = load_flow<C, kNzShared>(ring[0], row_s, col_s, nz, lane);
    cur0.row = f.row;
    cur0.col = f.col;
    cur0.cell = f.cell;
    cur0.fresh = f.fresh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cand[c] = fmaxf(bound[c],
                      cost(f.rl[c], f.rt[c], f.cl[c], f.ct[c], f.d,
                           fresh_of(f.fresh, c), inv_rate[c], delta,
                           cur0.rld[c], cur0.rt1[c], cur0.cld[c],
                           cur0.ct1[c]));
    }
    Committed<C> none;
    none.row = none.col = none.cell = -1;
    none.fresh = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      none.rld[c] = none.rt1[c] = none.cld[c] = none.ct1[c] = 0.0f;
    }
    evaluate(load_flow<C, kNzShared>(ring[1], row_s, col_s, nz, lane), false, 0, none,
             cur0, next0);
    loaded0 = load_flow<C, kNzShared>(ring[2], row_s, col_s, nz, lane);
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
    // Every lane may have stored a choice of this stage: each releases its
    // own stores to the producer.
    mbar_arrive(done_bar + 8 * (c % kStages));
  }
}

// C > kMaxPerLane cores a lane (K > 256): the cores' (bound, 1/r) pairs
// in memory, one flow at a time (see the design note). State and bitmap
// are in shared memory where the wrapper's layout put them (a null global
// pointer), else global; the cores' pairs follow the slots while they fit
// (cores_shared), else the global state.
__global__ void __launch_bounds__(kThreads, 1) coflow_assign_lanes_wide_kernel(
    const int* __restrict__ fi, const int* __restrict__ fj,
    const float* __restrict__ sizes, const float* __restrict__ rates,
    float delta, int n_flows, int k_cores, int n_ports, int c_lane,
    float2* state_global, uint32_t* nz_global, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + kBarBytes);
  int* out_ring = reinterpret_cast<int*>(smem + kBarBytes + kRingBytes);
  unsigned char* tail =
      smem + kBarBytes + kRingBytes + kOutBytes + kDummyBytes;
  const int plane = c_lane * kWarp;  // (load, tau) pairs a port
  const bool state_shared = state_global == nullptr;
  const bool nz_shared = nz_global == nullptr;
  float2* core = reinterpret_cast<float2*>(tail);  // (bound, 1/r) pairs
  if (cores_shared(c_lane)) tail += cores_bytes(c_lane);
  float2* row_s =
      state_shared ? reinterpret_cast<float2*>(tail) : state_global;
  float2* col_s = row_s + n_ports * plane;
  uint32_t* nz = nz_shared ? reinterpret_cast<uint32_t*>(col_s + n_ports * plane)
                           : nz_global;
  if (!cores_shared(c_lane)) core = col_s + n_ports * plane;
  const uint32_t full_bar = smem_u32(bars);            // + 8 * stage
  const uint32_t done_bar = smem_u32(bars + kStages);  // + 8 * stage

  // Core C*l + c of lane l sits at pair c * 32 + l; padding past K never
  // wins (its bound is +inf). Shared state is zeroed here, global state by
  // the caller, and the ring as in the register kernel.
  for (int x = threadIdx.x; x < plane; x += kThreads) {
    const int k = c_lane * (x % kWarp) + x / kWarp;
    const bool owned = k < k_cores;
    core[x] = make_float2(owned ? 0.0f : INFINITY,
                          __fdiv_rn(1.0f, owned ? rates[k] : 1.0f));
  }
  if (state_shared) {
    for (int x = threadIdx.x; x < 2 * n_ports * plane; x += kThreads)
      row_s[x] = make_float2(0.0f, 0.0f);
  }
  if (nz_shared) {
    for (int x = threadIdx.x; x < n_ports * n_ports * c_lane; x += kThreads)
      nz[x] = 0u;
  }
  for (int x = threadIdx.x; x < kRing; x += kThreads)
    ring[x] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, kWarp);
      mbar_init(done_bar + 8 * s, kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWarp) {
    produce(fi, fj, sizes, n_flows, n_ports, c_lane, ring, out_ring,
            full_bar, done_bar, out);
    return;
  }

  // ---- consumer warp: the chain, one flow at a time ---------------------
  int lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  const uint32_t lane_bit = 1u << lane;
  const uint32_t lanes_to_mine = lane_bit | (lane_bit - 1u);
  const int n_chunks = (n_flows + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    mbar_wait(full_bar + 8 * (ch % kStages), (ch / kStages) & 1);
    const int t_end = min(n_flows, (ch + 1) * kChunk);
    for (int t = ch * kChunk; t < t_end; ++t) {
      const int4 e = ring[t & (kRing - 1)];
      const float d = __int_as_float(e.w);
      // this lane's first argmin over its cores (strict `<`: ties keep the
      // lower core), with what the winner would commit
      float best = 0.0f, brld = 0.0f, brt1 = 0.0f, bcld = 0.0f, bct1 = 0.0f;
      int lc = 0;
#pragma unroll 8  // the loads of eight cores in flight at once
      for (int c = 0; c < c_lane; ++c) {
        const float2 r = row_s[e.x + c * kWarp + lane];
        const float2 q = col_s[e.y + c * kWarp + lane];
        const float2 kc = core[c * kWarp + lane];
        const float fresh = (nz[e.z + c] >> lane) & 1u ? 0.0f : 1.0f;
        float rld, rt1, cld, ct1;
        const float cand = fmaxf(kc.x, cost(r.x, r.y, q.x, q.y, d, fresh,
                                            kc.y, delta, rld, rt1, cld, ct1));
        if (c == 0 || cand < best) {
          best = cand;
          lc = c;
          brld = rld;
          brt1 = rt1;
          bcld = cld;
          bct1 = ct1;
        }
      }
      const uint32_t bits = __float_as_uint(best);
      const uint32_t least = __reduce_min_sync(kFullMask, bits);
      const uint32_t tied = __ballot_sync(kFullMask, bits == least);
      if ((tied & lanes_to_mine) == lane_bit) {  // this lane's core wins
        row_s[e.x + lc * kWarp + lane] = make_float2(brld, brt1);
        col_s[e.y + lc * kWarp + lane] = make_float2(bcld, bct1);
        core[lc * kWarp + lane].x = best;
        nz[e.z + lc] |= lane_bit;
        out_ring[t & (kRing - 1)] = c_lane * lane + lc;
      }
      __syncwarp();  // the commit, before any lane loads the next flow
    }
    mbar_arrive(done_bar + 8 * (ch % kStages));
  }
}

int launch_wide(const int* fi, const int* fj, const float* sizes,
                const float* rates, float delta, int n_flows, int k_cores,
                int n_ports, float2* state_global, uint32_t* nz_global,
                int* out, cudaStream_t stream) {
  const int c = (k_cores + kWarp - 1) / kWarp;
  if (state_global == nullptr && nz_global != nullptr) return -2;
  if (!cores_shared(c) && state_global == nullptr) return -2;
  const int smem = static_cast<int>(smem_bytes(c, n_ports,
                                               state_global == nullptr,
                                               nz_global == nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      coflow_assign_lanes_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  coflow_assign_lanes_wide_kernel<<<1, kThreads, smem, stream>>>(
      fi, fj, sizes, rates, delta, n_flows, k_cores, n_ports, c, state_global,
      nz_global, out);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool kStateShared, bool kNzShared>
int launch(const int* fi, const int* fj, const float* sizes, const float* rates,
           float delta, int n_flows, int k_cores, int n_ports,
           float2* state_global, uint32_t* nz_global, int* out,
           cudaStream_t stream) {
  auto kernel = coflow_assign_lanes_kernel<C, kStateShared, kNzShared>;
  const int smem =
      static_cast<int>(smem_bytes(C, n_ports, kStateShared, kNzShared));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, stream>>>(fi, fj, sizes, rates, delta, n_flows,
                                         k_cores, n_ports, state_global,
                                         nz_global, out);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_c(const int* fi, const int* fj, const float* sizes,
             const float* rates, float delta, int n_flows, int k_cores,
             int n_ports, float2* state_global, uint32_t* nz_global, int* out,
             cudaStream_t stream) {
  if (state_global == nullptr) {
    return nz_global == nullptr
               ? launch<C, true, true>(fi, fj, sizes, rates, delta, n_flows,
                                       k_cores, n_ports, nullptr, nullptr,
                                       out, stream)
               : launch<C, true, false>(fi, fj, sizes, rates, delta, n_flows,
                                        k_cores, n_ports, nullptr, nz_global,
                                        out, stream);
  }
  if (nz_global == nullptr) return -2;  // the bitmap never goes first
  return launch<C, false, false>(fi, fj, sizes, rates, delta, n_flows,
                                 k_cores, n_ports, state_global, nz_global,
                                 out, stream);
}

}  // namespace

// Dynamic shared memory of one launch: the wrapper's layout must agree.
extern "C" int coflow_assign_lanes_smem_bytes(int k_cores, int n_ports,
                                              int state_shared,
                                              int nz_shared) {
  return static_cast<int>(smem_bytes((k_cores + kWarp - 1) / kWarp, n_ports,
                                     state_shared != 0, nz_shared != 0));
}

// Bytes of the global scratch of the state (bitmap = 0; past 256 cores it
// also holds the cores' pairs where shared memory cannot) or of the bitmap
// (bitmap = 1), where it does not live in shared memory.
extern "C" long long coflow_assign_lanes_scratch_bytes(int k_cores,
                                                       int n_ports,
                                                       int bitmap) {
  const int c = (k_cores + kWarp - 1) / kWarp;
  if (bitmap) return nz_bytes(c, n_ports);
  return state_bytes(c, n_ports) + (cores_shared(c) ? 0 : cores_bytes(c));
}

// Launches the kernel on `stream` and returns cudaGetLastError(), -1 for
// K < 1, -2 for a bitmap in shared memory beside global state (or global
// cores' pairs without a global state). All pointers are device pointers;
// `state_global` and `nz_global` are null where that part lives in shared
// memory, else zeroed buffers of the sizes
// coflow_assign_lanes_scratch_bytes gives.
extern "C" int coflow_assign_lanes_launch(const int* fi, const int* fj,
                                          const float* sizes,
                                          const float* rates, float delta,
                                          int n_flows, int k_cores,
                                          int n_ports, float2* state_global,
                                          uint32_t* nz_global, int* out,
                                          cudaStream_t stream) {
  if (k_cores < 1) return -1;
  switch ((k_cores + kWarp - 1) / kWarp) {
#define CASE_C(C)                                                          \
  case C:                                                                  \
    return launch_c<C>(fi, fj, sizes, rates, delta, n_flows, k_cores,      \
                       n_ports, state_global, nz_global, out, stream);
    CASE_C(1) CASE_C(2) CASE_C(3) CASE_C(4) CASE_C(5) CASE_C(6) CASE_C(7)
    CASE_C(8)
#undef CASE_C
    default:  // past kMaxPerLane cores a lane
      return launch_wide(fi, fj, sizes, rates, delta, n_flows, k_cores,
                         n_ports, state_global, nz_global, out, stream);
  }
}
