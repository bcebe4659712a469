// Blocked GQA self-attention forward (flash attention) for Hopper, fp32,
// on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`)
// for float32 inputs; bfloat16 inputs go to flash_attention_sm90.cu. For
// every batch row b and query head h it computes
//   o[b, :, h] = softmax(scale * q[b, :, h] . k[b, :, h / group]^T + mask)
//                . v[b, :, h / group]
// with positions implicitly 0..Sq-1 for q and 0..Sk-1 for k (Sq and Sk may
// differ; the causal mask is then aligned top-left, as in the Pallas
// kernel), a causal mask (kp <= qp) and/or a sliding window
// (kp > qp - window). As in the Pallas kernel: q is pre-scaled; the
// softmax is the fp32 online softmax (m, l, acc) over kv tiles; masked
// scores take the finite value -0.7 * FLT_MAX; kv tiles that are wholly
// masked for the whole q tile are skipped; rows with l == 0 give 0. A
// masked score's weight is set to 0 outright, so a row that sees no key at
// all (possible only with Sq > Sk and a window) has l == 0 and gives 0.
//
// What bounds it on an H100: operations. fp32 inputs must meet the
// reference's 1e-5, which one TF32 product (10-bit mantissa) misses. The
// 3xTF32 split keeps fp32 accuracy on the tensor cores: x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi), and
//   a . b ~ hi_a . hi_b + hi_a . lo_b + lo_a . hi_b,
// each a tf32 product summed in the fp32 accumulator (lo . lo is below
// fp32's rounding). Three TF32 products at 495 TFLOP/s bound the TinyLlama
// prefill shape (B=8, S=2048, H=32, KVH=4, Dh=64, causal, 1.374e11 FLOP)
// at 0.833 ms, against 2.051 ms for fp32 FFMA on the CUDA cores.
//
// Design, in two kernels launched back to back on one stream:
//  1. The pre-pass (`split_kv_kernel`) reads K and V once with the
//     caller's strides and writes four tf32-valued fp32 planes that the
//     wrapper allocates, zero past Sk: K_hi, K_lo as (B, KVH, Sk_pad, Dh)
//     and V^T_hi, V^T_lo as (B, KVH, Dh, Sk_pad), Sk_pad = Sk rounded up
//     to the kv tile. V is transposed because a tf32 wgmma takes only
//     K-major operands, and in P.V the sum runs over keys. Within each run
//     of 8 keys, V^T holds them in the order 0 2 4 6 1 3 5 7: that is the
//     order in which a thread's accumulator of S holds them (columns 2c
//     and 2c + 1 of 8), so P goes from the S accumulator to the A
//     registers of P.V (k = c and c + 4) with no shuffle and no trip
//     through shared memory.
//  2. The attention kernel, shaped as flash_attention_sm90.cu: one CTA per
//     (q tile, head, batch row) of block_q(Dh) rows, a consumer warpgroup
//     per 64 of them and one producer warpgroup, of which one thread keeps
//     TMA loads of ring items in flight. An item is 32 KB: a hi and a lo
//     plane of 64 keys by 64 head-dim columns (K) or of 64 head-dim rows
//     by 64 keys (V^T), each plane two 128-byte-swizzled boxes of 32 fp32
//     columns. A kv tile of 64 keys is Dh/64 K items, then Dh/64 V items.
//     Each consumer warpgroup loads its 64 Q rows once with the caller's
//     strides, multiplies them by the scale, splits them and stores both
//     planes swizzled in shared memory. For each visible kv tile it runs
//       S = Q_lo.K_hi^T + Q_hi.K_lo^T + Q_hi.K_hi^T  (wgmma m64n64k8 tf32,
//           A and B from shared memory, per 8 columns the small terms
//           first), releasing each K item as its products finish;
//       the mask on boundary tiles only, the fp32 online softmax with expf;
//       P split into hi and lo in registers;
//       O += P_lo.V^T_hi + P_hi.V^T_lo + P_hi.V^T_hi  (wgmma m64n64k8
//           tf32, A from registers, one 64-column accumulator panel per V
//           item);
//     then O / l (rows with l == 0 give 0) is stored for rows below Sq.
//     The q tiles are issued last-first, so under a causal mask the
//     longest CTAs start first.
//  Shared memory sets the tiles. Q's two planes take 32 KB per 64 rows at
//  Dh=64, 64 KB at 128 and 128 KB at 256; the ring takes 32 KB a stage.
//  Dh=64: two consumer warpgroups (128 q rows) and 4 stages, 192 KB;
//  Dh=128: two and 3 stages, 224 KB; Dh=256: one (64 q rows) and 3
//  stages, 224 KB. The registers hold O (Dh / 2 a thread), S (32) and
//  P's two planes (64): at Dh=256, 224 of the 255 a thread of the CTA's
//  256 may have; at Dh 64 and 128 the consumers take 240 from the
//  producer (setmaxnreg).
//
// Numerics: the split rounds to nearest, ties away (cvt.rna.tf32.f32), as
// `split_tf32_plain` in kernels/flash_attention.py does bit for bit; x - hi
// is exact. No single TF32 product, no __expf, no double; the build passes
// -fmad=false, so each separate multiply and add rounds on its own.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBlockK = 64;          // keys a kv tile, at every head dim
constexpr int kChunk = 64;           // head-dim columns of one ring item
constexpr int kSplitRows = 32;       // keys one pre-pass block takes
constexpr uint32_t kRowBytes = 128;  // one swizzled row: 32 fp32
constexpr uint32_t kBox = 64 * kRowBytes;  // 64 rows of 32 fp32: 8 KB
constexpr uint32_t kItemBytes = 4 * kBox;  // hi and lo, two boxes each
// The reference's NEG_INF = -0.7 * finfo(float32).max, formed in double
// and rounded to float as jnp.where does.
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

// q rows of a CTA at head dim `dh`: a consumer warpgroup per 64 (see the
// design note), and the ring's stages.
__host__ __device__ constexpr int block_q(int dh) { return dh > 128 ? 64 : 128; }
__host__ __device__ constexpr int ring_stages(int dh) { return dh > 64 ? 3 : 4; }

struct Strides {
  long long b, s, h, d;
};

struct Params {
  const float* q;
  Strides qs;
  float* o;
  long long os_b, os_s, os_h;  // element strides of o (Dh stride 1)
  int batch, seq_q, seq_k, sk_pad, n_kv_heads, group;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

// x rounded to tf32 (nearest, ties away from zero), as an fp32 value whose
// low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact); lo is 0
// where x is not finite.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = isfinite(x) ? tf32_rna(__fsub_rn(x, hi)) : 0.0f;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

// One 2-D TMA load of a (32 columns x 64 rows) box at (x, y) into `dst`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

#define ACC32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ACC32_OUT(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[0..32) += A(smem, 64 x 8 tf32) . B(smem, 8 x 64 tf32), both K-major;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACC32
      ", %32, %33, p, 1, 1;\n}\n"
      : ACC32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0..32) += A(registers, 64 x 8 tf32) . B(smem, 8 x 64 tf32, K-major).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32_OUT(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// The pre-pass: keys [32 x, 32 x + 32) of head (z, y). K's rows go out as
// they come (coalesced along Dh); V's go through shared memory to come out
// transposed, coalesced along the keys, each run of 8 keys in the order
// 0 2 4 6 1 3 5 7.
template <int kDh>
__global__ void __launch_bounds__(256) split_kv_kernel(
    const float* __restrict__ k, const float* __restrict__ v, const Strides ks,
    const Strides vs, int seq_k, int sk_pad, int n_kv_heads,
    long long plane, float* __restrict__ kp, float* __restrict__ vp) {
  __shared__ float vt[kSplitRows][kDh + 1];
  const int s0 = blockIdx.x * kSplitRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long head = static_cast<long long>(b) * n_kv_heads + kvh;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int e = threadIdx.x; e < kSplitRows * kDh; e += blockDim.x) {
    const int r = e / kDh;
    const int d = e % kDh;
    const int s = s0 + r;
    const bool in = s < seq_k;
    float hi, lo;
    split_tf32(in ? kb[s * ks.s + d * ks.d] : 0.0f, hi, lo);
    const long long at = (head * sk_pad + s) * kDh + d;
    kp[at] = hi;
    kp[plane + at] = lo;
    vt[r][d] = in ? vb[s * vs.s + d * vs.d] : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSplitRows * kDh; e += blockDim.x) {
    const int d = e / kSplitRows;
    const int pos = e % kSplitRows;
    const int j = pos & 7;
    const int key = (pos & ~7) | (j < 4 ? 2 * j : 2 * j - 7);
    float hi, lo;
    split_tf32(vt[key][d], hi, lo);
    const long long at = (head * kDh + d) * sk_pad + s0 + pos;
    vp[at] = hi;
    vp[plane + at] = lo;
  }
}

template <int kDh>
__global__ void __launch_bounds__((block_q(kDh) / 64 + 1) * 128, 1)
    flash_attention_fp32_kernel(const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const Params p) {
  constexpr int kBlockQ = block_q(kDh);
  constexpr int kConsumers = kBlockQ * 2;  // 128 threads per 64 q rows
  constexpr int kStages = ring_stages(kDh);
  constexpr int kChunks = kDh / kChunk;    // K (and V) items a kv tile
  constexpr uint32_t kQPlane = kDh * 256;  // 64 rows of Dh fp32
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment; the launch adds the slack.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;  // warpgroup w: hi at 2 w kQPlane, lo after it
  const uint32_t ring = base + 2 * (kBlockQ / 64) * kQPlane;
  const uint32_t full_bar = ring + kStages * kItemBytes;  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;      // + 8 * stage

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
  int kb_hi = (seq_k + kBlockK - 1) / kBlockK - 1;
  if (p.causal) kb_hi = min(kb_hi, (min(q0 + kBlockQ, seq_q) - 1) / kBlockK);
  if (p.window > 0) {
    // visible iff kb * 64 + 63 > q0 - window
    const int lo_pos = q0 - p.window - kBlockK + 2;
    if (lo_pos > 0) kb_lo = (lo_pos + kBlockK - 1) / kBlockK;
  }
  const int n_tiles = max(kb_hi - kb_lo + 1, 0);
  const int n_items = n_tiles * 2 * kChunks;

  if (threadIdx.x == 0) {
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
    if constexpr (kConsumers > 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (threadIdx.x == kConsumers) {
      // rows of the two maps: plane, then (b, kvh), then key or Dh row
      const int k_plane = p.batch * p.n_kv_heads * p.sk_pad;
      const int k_row = (b * p.n_kv_heads + kvh) * p.sk_pad;
      const int v_plane = p.batch * p.n_kv_heads * kDh;
      const int v_row = (b * p.n_kv_heads + kvh) * kDh;
      for (int i = 0; i < n_items; ++i) {
        const int stage = i % kStages;
        mbar_wait(empty_bar + 8 * stage, ((i / kStages) & 1) ^ 1);
        const int part = i % (2 * kChunks);
        const int k0 = (kb_lo + i / (2 * kChunks)) * kBlockK;
        const uint32_t dst = ring + stage * kItemBytes;
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, kItemBytes);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const uint32_t box = dst + (2 * pl + g) * kBox;
            if (part < kChunks)  // K: 64 keys x columns 64 part + 32 g
              tma_load_2d(box, &tk, bar, kChunk * part + 32 * g,
                          pl * k_plane + k_row + k0);
            else  // V^T: head-dim rows 64 (part - kChunks) x keys k0 + 32 g
              tma_load_2d(box, &tv, bar, k0 + 32 * g,
                          pl * v_plane + v_row + kChunk * (part - kChunks));
          }
      }
      // Stay until the consumers have released every stage in use.
      for (int i = max(n_items, kStages); i < n_items + kStages; ++i)
        mbar_wait(empty_bar + 8 * (i % kStages), ((i / kStages) & 1) ^ 1);
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each -------------------------------
  if constexpr (kConsumers > 128) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  }
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // This thread's rows of the warpgroup's 64 (r, r + 8) and its first
  // column in each 8-column run of the accumulators.
  const int r = 16 * (t / 32) + lane / 4;
  const int cb = 2 * (lane % 4);
  const int qw0 = q0 + 64 * wg;
  const int qp0 = qw0 + r;
  const int qp1 = qp0 + 8;
  const uint32_t q_hi = sq + 2 * wg * kQPlane;
  const uint32_t q_lo = q_hi + kQPlane;

  // Q: read with the caller's strides, scaled, split, stored swizzled
  // (16-byte unit u of row `row` at unit u ^ (row % 8)); rows past Sq are 0.
  {
    const float* qb = p.q + b * p.qs.b + h * p.qs.h;
    for (int e = t; e < 64 * kDh; e += 128) {
      const int row = e / kDh;
      const int d = e % kDh;
      const int s = qw0 + row;
      float hi, lo;
      split_tf32(s < seq_q ? __fmul_rn(qb[s * p.qs.s + d * p.qs.d], p.scale)
                           : 0.0f,
                 hi, lo);
      const uint32_t at = (d / 32) * kBox + row * kRowBytes +
                          ((((d % 32) / 4) ^ (row % 8)) * 16) + (d % 4) * 4;
      st_shared(q_hi + at, hi);
      st_shared(q_lo + at, lo);
    }
    // the stores, visible to the async proxy (wgmma) of this warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = (kb_lo + tile) * kBlockK;
    const int item0 = tile * 2 * kChunks;

    // S = Q . K^T (64 x 64, fp32) in 3xTF32, one K item a 64-column chunk
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int item = item0 + c;
      mbar_wait(full_bar + 8 * (item % kStages), (item / kStages) & 1);
      const uint32_t kt = ring + (item % kStages) * kItemBytes;
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const uint32_t col = (kk / 4) * kBox + (kk % 4) * 32;
        const uint32_t qc = 2 * c * kBox + col;
        const uint64_t qh = kmajor_desc(q_hi + qc);
        const uint64_t ql = kmajor_desc(q_lo + qc);
        const uint64_t kh = kmajor_desc(kt + col);
        const uint64_t kl = kmajor_desc(kt + 2 * kBox + col);
        wgmma_tf32_ss(s, ql, kh, c > 0 || kk > 0);
        wgmma_tf32_ss(s, qh, kl, 1);
        wgmma_tf32_ss(s, qh, kh, 1);
      }
      wgmma_commit();
      if (c > 0) {  // the previous item's products are done: release it
        wgmma_wait<1>();
        mbar_arrive(empty_bar + 8 * ((item - 1) % kStages));
      }
    }
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(empty_bar + 8 * ((item0 + kChunks - 1) % kStages));

    // mask on boundary tiles (weight 0 outright), then the online softmax
    const bool boundary =
        k0 + kBlockK > seq_k || (p.causal && k0 + kBlockK - 1 > qw0) ||
        (p.window > 0 && k0 <= qw0 + 63 - p.window);
    uint32_t vis = 0xFFFFFFFFu;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        if (boundary) {
          const int kp = k0 + 8 * j + cb + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool v = kp < seq_k;
          if (p.causal) v = v && kp <= qp;
          if (p.window > 0) v = v && kp > qp - p.window;
          if (!v) {
            s[i] = kNegInf;
            vis &= ~(1u << i);
          }
        }
        if (e < 2) mx0 = fmaxf(mx0, s[i]);
        else mx1 = fmaxf(mx1, s[i]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(__fsub_rn(m0, mn0));
    const float alpha1 = expf(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool row0 = (i % 4) < 2;
      const float x = (vis >> i) & 1u ? expf(__fsub_rn(s[i], row0 ? mn0 : mn1))
                                      : 0.0f;
      s[i] = x;
      if (row0) rs0 = __fadd_rn(rs0, x);
      else rs1 = __fadd_rn(rs1, x);
    }
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), rs0);
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), rs1);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[c][i] = __fmul_rn(o[c][i], (i % 4) < 2 ? alpha0 : alpha1);

    // P = hi + lo in tf32, as the A registers of the 8 k-steps of P.V: for
    // k-step kk the thread's keys 8 kk + cb and 8 kk + cb + 1 are k = cb/2
    // and cb/2 + 4, the order V^T's planes hold them in
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float hi, lo;
      split_tf32(s[i], hi, lo);
      ph[i] = __float_as_uint(hi);
      pl[i] = __float_as_uint(lo);
    }

    // O += P . V in 3xTF32, one V item a 64-column panel of O
    fence_regs(ph);
    fence_regs(pl);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int item = item0 + kChunks + c;
      mbar_wait(full_bar + 8 * (item % kStages), (item / kStages) & 1);
      const uint32_t vt = ring + (item % kStages) * kItemBytes;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 8; ++kk) {
        const uint32_t col = (kk / 4) * kBox + (kk % 4) * 32;
        const uint64_t vh = kmajor_desc(vt + col);
        const uint64_t vl = kmajor_desc(vt + 2 * kBox + col);
        const int i = 4 * kk;
        wgmma_tf32_rs(o[c], pl[i], pl[i + 2], pl[i + 1], pl[i + 3], vh);
        wgmma_tf32_rs(o[c], ph[i], ph[i + 2], ph[i + 1], ph[i + 3], vl);
        wgmma_tf32_rs(o[c], ph[i], ph[i + 2], ph[i + 1], ph[i + 3], vh);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty_bar + 8 * ((item - 1) % kStages));
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(empty_bar + 8 * ((item0 + 2 * kChunks - 1) % kStages));
  }

  // O / l; rows with l == 0 give 0; rows at or past Sq are not stored
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
  float* ob = p.o + b * p.os_b + h * p.os_h;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kChunk * c + 8 * j + cb;
      if (qp0 < seq_q)
        *reinterpret_cast<float2*>(ob + qp0 * p.os_s + col) = make_float2(
            l0 > 0.0f ? __fdiv_rn(o[c][4 * j + 0], l0) : 0.0f,
            l0 > 0.0f ? __fdiv_rn(o[c][4 * j + 1], l0) : 0.0f);
      if (qp1 < seq_q)
        *reinterpret_cast<float2*>(ob + qp1 * p.os_s + col) = make_float2(
            l1 > 0.0f ? __fdiv_rn(o[c][4 * j + 2], l1) : 0.0f,
            l1 > 0.0f ? __fdiv_rn(o[c][4 * j + 3], l1) : 0.0f);
    }
}

// A 2-D map of one fp32 plane pair, (inner, outer) elements, inner stride
// 1, boxes of 32 x 64 under the 128B swizzle.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, void* ptr,
                  long long inner, long long outer) {
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t estride[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, gdim, gstride, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Dynamic shared memory of one CTA: Q's planes, the ring, the barriers,
// and the slack that aligns the tiles to 1024 bytes.
constexpr int smem_bytes(int dh) {
  return block_q(dh) * dh * 8 + ring_stages(dh) * static_cast<int>(kItemBytes) +
         16 * ring_stages(dh) + 1024;
}

int pad_keys(int seq_k) { return (seq_k + kBlockK - 1) / kBlockK * kBlockK; }

Strides strides_at(const long long* st) { return {st[0], st[1], st[2], st[3]}; }

template <int kDh>
int split(const float* k, const float* v, const long long* kst,
          const long long* vst, float* kp, float* vp, int batch, int seq_k,
          int n_kv, cudaStream_t stream) {
  const int sk_pad = pad_keys(seq_k);
  const long long plane = static_cast<long long>(batch) * n_kv * sk_pad * kDh;
  split_kv_kernel<kDh><<<dim3(sk_pad / kSplitRows, n_kv, batch), 256, 0, stream>>>(
      k, v, strides_at(kst), strides_at(vst), seq_k, sk_pad, n_kv, plane, kp, vp);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int launch(const float* q, const float* k, const float* v, float* o,
           const long long* st, float* kp, float* vp, int batch, int seq_q,
           int seq_k, int n_heads, int n_kv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kDh);
  static_assert(smem <= 232448, "above the 227 KB a block may use");
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -2;
  int err = split<kDh>(k, v, st + 4, st + 8, kp, vp, batch, seq_k, n_kv, stream);
  if (err != 0) return err;
  Params p;
  p.q = q;
  p.qs = strides_at(st);
  p.o = o;
  p.os_b = st[12];
  p.os_s = st[13];
  p.os_h = st[14];
  p.batch = batch;
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.sk_pad = pad_keys(seq_k);
  p.n_kv_heads = n_kv;
  p.group = n_heads / n_kv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  const long long heads2 = 2LL * batch * n_kv;
  CUtensorMap tk, tv;
  CUresult res = make_map(enc, &tk, kp, kDh, heads2 * p.sk_pad);
  if (res == CUDA_SUCCESS) res = make_map(enc, &tv, vp, p.sk_pad, heads2 * kDh);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attention_fp32_kernel<kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qt = (seq_q + block_q(kDh) - 1) / block_q(kDh);
  flash_attention_fp32_kernel<kDh>
      <<<dim3(n_heads, batch, n_qt), (block_q(kDh) / 64 + 1) * 128, smem,
         stream>>>(tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory of one attention CTA at `head_dim` (0 if the
// kernel is not built for it).
extern "C" int flash_attention_fp32_sm90_smem_bytes(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 ? smem_bytes(head_dim)
                                                               : 0;
}

// The q rows of one attention CTA at `head_dim` (0 if not built for it).
extern "C" int flash_attention_fp32_sm90_block_q(int head_dim) {
  return head_dim == 64 || head_dim == 128 || head_dim == 256 ? block_q(head_dim) : 0;
}

// The pre-pass alone: k, v (B, Sk, KVH, Dh) fp32 with element strides
// `strides` (b, s, h, d of k, then of v) into the planes `kp` (2, B, KVH,
// Sk_pad, Dh) and `vp` (2, B, KVH, Dh, Sk_pad), Sk_pad = Sk rounded up to
// 64. Returns cudaGetLastError(), or -1 for a head_dim not built.
extern "C" int flash_attention_fp32_sm90_split(const void* k, const void* v,
                                               const long long* strides,
                                               void* kp, void* vp, int batch,
                                               int seq_k, int n_kv_heads,
                                               int head_dim,
                                               cudaStream_t stream) {
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* kpf = static_cast<float*>(kp);
  float* vpf = static_cast<float*>(vp);
#define SPLIT(D) split<D>(kf, vf, strides, strides + 4, kpf, vpf, batch, seq_k, \
                          n_kv_heads, stream)
  if (head_dim == 64) return SPLIT(64);
  if (head_dim == 128) return SPLIT(128);
  if (head_dim == 256) return SPLIT(256);
#undef SPLIT
  return -1;
}

// Launches the pre-pass and then the attention kernel on `stream` for fp32
// q (B, Sq, H, Dh) and k, v (B, Sk, KVH, Dh), and returns
// cudaGetLastError(); -1 for a head_dim the kernel is not built for, -2 if
// libcuda offers no cuTensorMapEncodeTiled, -(1000 + CUresult) if a tensor
// map is refused. `strides` holds 16 element strides: (b, s, h, d) of q,
// k, v and o in that order; o's d stride is 1. `kp` and `vp` are the
// planes' buffers (see flash_attention_fp32_sm90_split), written before
// they are read; `o` is written, never read.
extern "C" int flash_attention_fp32_sm90_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, void* kp, void* vp, int batch, int seq_q,
    int seq_k, int n_heads, int n_kv_heads, int head_dim, float scale,
    int causal, int window, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* kpf = static_cast<float*>(kp);
  float* vpf = static_cast<float*>(vp);
  if (head_dim == 64)
    return launch<64>(qf, kf, vf, of, strides, kpf, vpf, batch, seq_q, seq_k,
                      n_heads, n_kv_heads, scale, causal, window, stream);
  if (head_dim == 128)
    return launch<128>(qf, kf, vf, of, strides, kpf, vpf, batch, seq_q, seq_k,
                       n_heads, n_kv_heads, scale, causal, window, stream);
  if (head_dim == 256)
    return launch<256>(qf, kf, vf, of, strides, kpf, vpf, batch, seq_q, seq_k,
                       n_heads, n_kv_heads, scale, causal, window, stream);
  return -1;
}
