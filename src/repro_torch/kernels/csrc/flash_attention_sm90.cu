// Blocked GQA self-attention forward (flash attention) for Hopper, bf16.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`)
// for bfloat16 inputs; fp32 inputs go to the SIMT kernel in
// flash_attention.cu. For every batch row b and query head h it computes
//   o[b, :, h] = softmax(scale * q[b, :, h] . k[b, :, h / group]^T + mask)
//                . v[b, :, h / group]
// with positions implicitly 0..Sq-1 for q and 0..Sk-1 for k (Sq and Sk may
// differ: cross-attention, or a query block against a longer key run), a
// causal mask (kp <= qp, both counted from 0, so with Sq != Sk the mask is
// aligned top-left as in the Pallas kernel) and/or a sliding window
// (kp > qp - window). A row with no visible key gives 0.
//
// What bounds it on an H100: operations. At the TinyLlama prefill shape
// (B=8, S=2048, H=32, KVH=4, Dh=64, causal) the two products need 1.374e11
// FLOP against 151 MB of q, k, v and o, about 900 FLOP per byte, so the
// bf16 tensor cores (989 TFLOP/s) bound it at 0.139 ms. The design puts
// both products on the tensor cores (wgmma, bf16 in, fp32 accumulate) and
// takes the loads off the threads that compute: TMA copies each tile into
// swizzled shared memory while the math runs on the previous one.
//
// Design: one CTA of 384 threads per (q tile of 128 rows, head, batch row).
// Warpgroups 0 and 1 are consumers, each owning 64 q rows; warpgroup 2 is
// the producer, of which one thread issues every TMA load: the CTA's Q tile
// once, then K and V tiles of BK rows into a ring of 2 stages, each stage
// completing on a `full` mbarrier and released by the consumers on an
// `empty` one. Tiles are 128-byte rows under the 128B swizzle; a Dh=128
// tile is two 64-column panels, a Dh=256 tile four. BK is 128 for Dh 64
// and 128. At Dh=256 it is 64: the Q tile alone takes 64 KB, and two
// stages of 128-row K and V tiles would take 256 KB more, past the 227 KB
// a CTA may use; with 64-row tiles the CTA takes 192 KB. The registers
// then hold O as 4 panels of 64 x 64 fp32 (128 a thread) beside S at
// 64 x 64 (32 a thread), inside the consumers' 240.
// For each kv tile a consumer warpgroup runs
//   S = Q.K^T   wgmma m64n{BK}k16, A and B from shared memory, K-major;
//   scale S in fp32 (log2(e) folded in), mask only on boundary tiles, the
//   fp32 online softmax (m, l, acc) with exp2f;
//   P -> bf16 in registers (the fp32 accumulator layout of S, packed in
//   pairs, is the A-register fragment layout);
//   O += P.V    wgmma m64n64k16 per 64-column panel, A from registers,
//   V from shared memory as an MN-major B (transposed).
// Then O / l (rows with l == 0 give 0) is stored for rows below S.
//
// Schedule, as in the Pallas kernel: kv tiles wholly masked by the causal
// or window bound are never loaded; the elementwise mask runs only on
// boundary tiles (the diagonal, the window's lower edge, keys past Sk).
// Rows past Sq and keys past Sk are zero-filled by TMA, keys past Sk get
// p = 0 and rows past Sq are not stored.
// q tiles are issued last-first (the slowest grid dimension), so under a
// causal mask the longest CTAs start first. The tensor maps are 4-D over
// (Dh, and B, S, H ordered by stride) with the caller's strides, so the
// kernel reads strided views without a copy.
//
// Numerics: Q.K^T of bf16 values is exact per product and summed in fp32;
// P is rounded to bf16 before P.V (at most 2^-9 relative per weight, the
// same cast the reference model's "xla" path makes); l sums the fp32 p.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;   // q rows per CTA (two warpgroups of 64)
constexpr int kBlockK = 128;   // kv rows per tile at Dh 64 and 128
constexpr int kStages = 2;
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr uint32_t kRowBytes = 128;  // one swizzled row: 64 bf16

// kv rows per tile at head dim `dh` (see the design note).
__host__ __device__ constexpr int block_k(int dh) { return dh > 128 ? 64 : kBlockK; }

// Where each of the three outer dimensions sits in a tensor map (1..3).
struct MapPos {
  int h, s, b;
};

struct Params {
  __nv_bfloat16* o;
  long long os_b, os_s, os_h;  // element strides of o
  MapPos qpos, kpos, vpos;
  int seq_q, seq_k;
  int group;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
  int window;  // <= 0: no window
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 4-D TMA load of a (64 columns x 1 x rows x 1) box into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, const MapPos& pos,
                                         int row, int head, int batch) {
  const int c1 = pos.s == 1 ? row : pos.h == 1 ? head : batch;
  const int c2 = pos.s == 2 ? row : pos.h == 2 ? head : batch;
  const int c3 = pos.s == 3 ? row : pos.h == 3 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128B swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major tile (Q, K): 8-row groups 1024 bytes apart; the leading offset is
// unused under the swizzle. One k-step of 16 bf16 advances the start by 32 B.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// MN-major tile (V as the B of P.V, 64 columns): 8-row groups along K are
// 1024 bytes apart. Both offsets are set to that stride: with one 64-column
// chunk per instruction the other offset is never walked.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0..64) += A(smem, 64 x 16) . B(smem, 16 x 128); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0..32) += A(smem, 64 x 16) . B(smem, 16 x 64); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0..32) += A(registers, 64 x 16 bf16) . B(smem, 16 x 64, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kDh>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const Params p) {
  constexpr int kPanels = kDh / 64;
  constexpr int kBK = block_k(kDh);
  constexpr uint32_t kPanelQ = kBlockQ * kRowBytes;
  constexpr uint32_t kPanelK = kBK * kRowBytes;
  constexpr uint32_t kQBytes = kPanels * kPanelQ;
  constexpr uint32_t kKBytes = kPanels * kPanelK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment; the launch adds the slack.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t skv = base + kQBytes;  // stage s: K, then V
  const uint32_t bars = skv + 2 * kStages * kKBytes;
  const uint32_t q_bar = bars;
  const uint32_t full_bar = bars + 8;                 // + 8 * stage
  const uint32_t empty_bar = bars + 8 + 8 * kStages;  // + 8 * stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const int seq_q = p.seq_q;
  const int seq_k = p.seq_k;
  const int kvh = h / p.group;

  // Visible kv tiles: none wholly in the future of the tile's last row
  // (causal), none wholly before its first row's window. With Sq > Sk and a
  // window, a tile may see none at all.
  int kb_lo = 0;
  int kb_hi = (seq_k + kBK - 1) / kBK - 1;
  if (p.causal) kb_hi = min(kb_hi, (min(q0 + kBlockQ, seq_q) - 1) / kBK);
  if (p.window > 0) {
    // visible iff kb * BK + BK - 1 > q0 - window
    const int lo_pos = q0 - p.window - kBK + 2;
    if (lo_pos > 0) kb_lo = (lo_pos + kBK - 1) / kBK;
  }
  const int n_tiles = max(kb_hi - kb_lo + 1, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, kQBytes);
#pragma unroll
      for (int g = 0; g < kPanels; ++g)
        tma_load(sq + g * kPanelQ, &tq, q_bar, 64 * g, p.qpos, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kStages) & 1) ^ 1);
        const int k0 = (kb_lo + it) * kBK;
        const uint32_t sk = skv + stage * 2 * kKBytes;
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * kKBytes);
#pragma unroll
        for (int g = 0; g < kPanels; ++g) {
          tma_load(sk + g * kPanelK, &tk, bar, 64 * g, p.kpos, k0, kvh, b);
          tma_load(sk + kKBytes + g * kPanelK, &tv, bar, 64 * g, p.vpos, k0,
                   kvh, b);
        }
      }
      // Stay until the consumers have released every stage in use.
      for (int it = max(n_tiles, kStages); it < n_tiles + kStages; ++it)
        mbar_wait(empty_bar + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // This thread's rows of the warpgroup's 64 (r, r + 8) and its first
    // column in each 8-column chunk of the accumulators.
    const int r = 16 * (t / 32) + lane / 4;
    const int cb = 2 * (lane % 4);
    const int qp0 = q0 + 64 * wg + r;
    const int qp1 = qp0 + 8;
    const float c = p.scale_log2;
    const uint32_t sq_wg = sq + wg * 64 * kRowBytes;

    float o[kPanels][32];
#pragma unroll
    for (int g = 0; g < kPanels; ++g)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[g][i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const int k0 = (kb_lo + it) * kBK;
      const uint32_t sk = skv + stage * 2 * kKBytes;
      const uint32_t sv = sk + kKBytes;
      mbar_wait(full_bar + 8 * stage, (it / kStages) & 1);

      // S = Q . K^T (64 x BK, fp32)
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = kmajor_desc(sq_wg + (kk / 4) * kPanelQ + col);
        const uint64_t db = kmajor_desc(sk + (kk / 4) * kPanelK + col);
        if constexpr (kBK == 128) wgmma_m64n128k16_ss(s, da, db, kk > 0);
        else wgmma_m64n64k16_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask on boundary tiles, online softmax
      const bool boundary =
          k0 + kBK > seq_k || (p.causal && k0 + kBK - 1 > q0) ||
          (p.window > 0 && k0 <= q0 + kBlockQ - 1 - p.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * c;
          if (boundary) {
            const int kp = k0 + 8 * j + cb + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            bool vis = kp < seq_k;
            if (p.causal) vis = vis && kp <= qp;
            if (p.window > 0) vis = vis && kp > qp - p.window;
            if (!vis) x = -INFINITY;
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // a row with nothing visible yet keeps p = 0 and alpha = 0
      const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
      const float alpha0 = exp2f(m0 - mu0);
      const float alpha1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j + 0] = exp2f(s[4 * j + 0] - mu0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - mu0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - mu1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - mu1);
        rs0 += s[4 * j + 0] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int g = 0; g < kPanels; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[g][4 * j + 0] *= alpha0;
          o[g][4 * j + 1] *= alpha0;
          o[g][4 * j + 2] *= alpha1;
          o[g][4 * j + 3] *= alpha1;
        }
      // P in bf16, as the A fragments of the BK / 16 k-steps of P.V
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P . V
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
#pragma unroll
      for (int g = 0; g < kPanels; ++g) fence_regs(o[g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int g = 0; g < kPanels; ++g)
          wgmma_m64n64k16_rs(o[g], pa[kk],
                             mnmajor_desc(sv + g * kPanelK + kk * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int g = 0; g < kPanels; ++g) fence_regs(o[g]);
      mbar_arrive(empty_bar + 8 * stage);
    }

    // O / l; rows with l == 0 give 0; rows at or past Sq are not stored
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* obase = p.o + b * p.os_b + h * p.os_h;
#pragma unroll
    for (int g = 0; g < kPanels; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * g + 8 * j + cb;
        if (qp0 < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(obase + qp0 * p.os_s + col) =
              __floats2bfloat162_rn(o[g][4 * j + 0] * inv0, o[g][4 * j + 1] * inv0);
        if (qp1 < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(obase + qp1 * p.os_s + col) =
              __floats2bfloat162_rn(o[g][4 * j + 2] * inv1, o[g][4 * j + 3] * inv1);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda); null if the installed libcuda lacks it.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (Dh, then B, S, H in increasing stride) of a bf16 tensor
// with element strides st = (b, s, h, d), d == 1, and a box of 64 columns
// by `rows` rows. A dimension of extent 1 gets the largest stride, so its
// stride (never walked) may be anything.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  const long long* st, int batch, int seq, int heads, int dh,
                  int rows, MapPos* pos) {
  long long ext[3] = {batch, seq, heads};
  long long str[3] = {st[0], st[1], st[2]};
  long long top = dh;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && str[i] * ext[i] > top) top = str[i] * ext[i];
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) str[i] = top;
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (str[order[j]] < str[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(dh), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int dim = order[i];
    gdim[i + 1] = static_cast<cuuint64_t>(ext[dim]);
    gstride[i] = static_cast<cuuint64_t>(str[dim]) * 2;
    if (dim == 0) pos->b = i + 1;
    if (dim == 1) {
      pos->s = i + 1;
      box[i + 1] = static_cast<cuuint32_t>(rows);
    }
    if (dim == 2) pos->h = i + 1;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Dynamic shared memory of one CTA: the Q tile, the K/V ring, the
// barriers, and the slack that aligns the tiles to 1024 bytes.
constexpr int smem_bytes(int dh) {
  return (dh / 64) * (kBlockQ + 2 * kStages * block_k(dh)) * static_cast<int>(kRowBytes) +
         8 * (1 + 2 * kStages) + 1024;
}

template <int kDh>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int n_heads, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kDh);
  static_assert(smem <= 232448, "above the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_sm90<kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.seq_q + kBlockQ - 1) / kBlockQ;
  flash_attention_kernel_sm90<kDh>
      <<<dim3(n_heads, batch, n_qt), kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory a launch requests for `head_dim` (0 if the
// kernel is not built for it).
extern "C" int flash_attention_sm90_smem_bytes(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 ? smem_bytes(head_dim)
                                                               : 0;
}

// The kv rows of one K or V tile at `head_dim` (0 if not built for it).
extern "C" int flash_attention_sm90_block_k(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 ? block_k(head_dim) : 0;
}

// Launches the kernel on `stream` for bf16 q (B, Sq, H, Dh) and k, v
// (B, Sk, KVH, Dh) and returns cudaGetLastError(); -1 for a head_dim the
// kernel is not built for, -2 if
// libcuda offers no cuTensorMapEncodeTiled, -(1000 + CUresult) if a
// tensor map is refused. `strides` holds 16 element strides: (b, s, h, d)
// of q, k, v and o in that order; the wrapper has checked what TMA needs
// (d stride 1, other strides multiples of 16 bytes, 16-byte aligned bases).
// `o` is written, never read.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           const long long* strides, int batch,
                                           int seq_q, int seq_k, int n_heads,
                                           int n_kv_heads, int head_dim, float scale,
                                           int causal, int window,
                                           cudaStream_t stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return -1;
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -2;
  Params p;
  CUtensorMap tq, tk, tv;
  const int bk = block_k(head_dim);
  CUresult res = make_map(enc, &tq, q, strides, batch, seq_q, n_heads, head_dim,
                          kBlockQ, &p.qpos);
  if (res == CUDA_SUCCESS)
    res = make_map(enc, &tk, k, strides + 4, batch, seq_k, n_kv_heads, head_dim, bk,
                   &p.kpos);
  if (res == CUDA_SUCCESS)
    res = make_map(enc, &tv, v, strides + 8, batch, seq_k, n_kv_heads, head_dim, bk,
                   &p.vpos);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  p.o = static_cast<__nv_bfloat16*>(o);
  p.os_b = strides[12];
  p.os_s = strides[13];
  p.os_h = strides[14];
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.group = n_heads / n_kv_heads;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  p.window = window;
  if (head_dim == 64) return launch<64>(tq, tk, tv, p, n_heads, batch, stream);
  if (head_dim == 128) return launch<128>(tq, tk, tv, p, n_heads, batch, stream);
  return launch<256>(tq, tk, tv, p, n_heads, batch, stream);
}
