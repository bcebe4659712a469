// Blocked GQA self-attention forward (flash attention), fp32, on the CUDA
// cores of a Hopper card.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`)
// for float32 inputs; bfloat16 inputs go to the tensor-core kernel in
// flash_attention_sm90.cu. For every batch row b and query head h it computes
//   o[b, :, h] = softmax(scale * q[b, :, h] . k[b, :, h / group]^T + mask)
//                . v[b, :, h / group]
// with positions implicitly 0..Sq-1 for q and 0..Sk-1 for k (Sq and Sk may
// differ; the causal mask is then aligned top-left, as in the Pallas
// kernel), a causal mask (kp <= qp) and/or a sliding window
// (kp > qp - window). As in the Pallas kernel: q is pre-scaled; the
// softmax is the fp32 online softmax (m, l, acc) over kv blocks; masked
// scores take the finite value -0.7 * FLT_MAX; kv blocks that are wholly
// masked for the whole q block are skipped; rows with l == 0 give 0. So a
// row with no visible key at all (possible only with Sq > Sk and a window)
// gives what the Pallas kernel gives there, which depends on its blocks:
// such rows are outside the contract.
//
// What bounds it on an H100: operations, and here the fp32 ones. fp32
// inputs must meet the reference's 1e-5, which rules out TF32, and wgmma
// has no full-fp32 mode, so both products run as fp32 fmaf chains on the
// CUDA cores (67 TFLOP/s peak): about 2 ms at the TinyLlama prefill shape
// (B=8, S=2048, H=32, Dh=64, causal, 1.4e11 FLOP). The serving path runs
// bf16 and never reaches this kernel.
//
// Design: one CTA of 256 threads per (q block of 64 rows, head, batch row).
// The CTA stages its q block once and then walks the visible kv blocks of
// 64 rows, staging K and V in shared memory. The 16 x 16 threads
// each own 4 rows (ty*4 .. ty*4+3) of the 64 x 64 score tile, in columns
// tx, tx+16, tx+32, tx+48, and the same 4 rows of the output in columns
// g*64 + tx*4 .. +3. The 16 threads of a row group sit in one half warp,
// so the row max and row sum are xor-shuffle butterflies (every lane ends
// with the bitwise same value). P goes through shared memory to the P.V
// product. Rows are padded by 4 floats so that the 16-byte reads of the
// products hit distinct banks. Reads of q, k and v follow the strides the
// caller passes, so no transpose precedes the kernel; Sq and Sk need not be
// multiples of 64 (rows past Sq and keys past Sk are zero-filled, keys
// past Sk get p = 0). At Dh=256 the three tiles and P take 217 KB of
// shared memory, so one CTA fits an SM and may use up to 255 registers.
// The q blocks are issued last-first, so under a causal mask the longest
// CTAs start first.
//
// Numerics: the products are fp32 fmaf chains (explicit fmaf contracts even
// under -fmad=false); exponentials are expf, never __expf; no TF32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPad = 4;
// The reference's NEG_INF = -0.7 * finfo(float32).max, formed in double
// and rounded to float as jnp.where does.
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Strides {
  long long b, s, h, d;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int seq_q, seq_k;
  int group;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

// Stage rows [row0, row0 + 64) of one head of x into dst (64 x kLd fp32),
// times `mul`; rows at or past `seq` become zeros.
template <int kDh>
__device__ __forceinline__ void stage_tile(float* dst, const float* base,
                                           const Strides& st, int row0,
                                           int seq, float mul) {
  constexpr int kLd = kDh + kPad;
  for (int e = threadIdx.x; e < kBlockQ * kDh; e += kThreads) {
    const int r = e / kDh;
    const int d = e % kDh;
    const int s = row0 + r;
    float x = 0.0f;
    if (s < seq) x = base[s * st.s + d * st.d] * mul;
    dst[r * kLd + d] = x;
  }
}

template <int kDh>
__global__ void __launch_bounds__(kThreads, kDh > 128 ? 1 : 2)
    flash_attention_kernel(const Params p) {
  constexpr int kLd = kDh + kPad;     // row stride of Qs, Ks, Vs (floats)
  constexpr int kLdP = kBlockK + kPad;  // row stride of Ps
  constexpr int kCols = kDh / 16;     // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * kLd;
  float* Vs = Ks + kBlockK * kLd;
  float* Ps = Vs + kBlockK * kLd;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = qb * kBlockQ;
  const int seq_q = p.seq_q;
  const int seq_k = p.seq_k;

  const float* qbase = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* kbase = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* vbase = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  float* obase = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  stage_tile<kDh>(Qs, qbase, p.qs, q0, seq_q, p.scale);

  // Visible kv blocks: none wholly in the future of the q block's last row
  // (causal), none wholly before its first row's window.
  int kb_lo = 0;
  int kb_hi = (seq_k + kBlockK - 1) / kBlockK - 1;
  if (p.causal) kb_hi = min(kb_hi, (min(q0 + kBlockQ, seq_q) - 1) / kBlockK);
  if (p.window > 0) {
    // visible iff kb * 64 + 63 > q0 - window
    const int lo_pos = q0 - p.window - kBlockK + 2;
    if (lo_pos > 0) kb_lo = (lo_pos + kBlockK - 1) / kBlockK;
  }

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the last block's readers of Ks, Vs, Ps are done
    stage_tile<kDh>(Ks, kbase, p.ks, k0, seq_k, 1.0f);
    stage_tile<kDh>(Vs, vbase, p.vs, k0, seq_k, 1.0f);
    __syncthreads();

    // s = (q * scale) . k^T for 4 rows x 4 columns
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * kLd + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool vis = true;
        if (p.causal) vis = vis && kp <= qp;
        if (p.window > 0) vis = vis && kp > qp - p.window;
        if (!vis || kp >= seq_k) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float pj = kp < seq_k ? expf(s[i][j] - m_new) : 0.0f;
        rsum += pj;
        Ps[(ty * 4 + i) * kLdP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = alpha * l_run[i] + rsum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V for 4 rows x kCols columns
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * kLdP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int g = 0; g < kDh / 64; ++g) {
          const float4 vb = *reinterpret_cast<const float4*>(
              &Vs[(kk + t) * kLd + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = t == 0 ? pa[i].x
                           : t == 1 ? pa[i].y
                           : t == 2 ? pa[i].z
                                    : pa[i].w;
            acc[i][g * 4 + 0] = fmaf(pv, vb.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pv, vb.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pv, vb.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pv, vb.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    const float safe = l_run[i] == 0.0f ? 1.0f : l_run[i];
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        obase[row * p.os.s + d * p.os.d] = acc[i][g * 4 + e] / safe;
      }
  }
}

template <int kDh>
int launch(const Params& p, int n_qblk, int n_heads, int batch,
           cudaStream_t stream) {
  const int smem =
      (3 * kBlockQ * (kDh + kPad) + kBlockQ * (kBlockK + kPad)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<kDh>
      <<<dim3(n_qblk, n_heads, batch), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for float32 q (B, Sq, H, Dh) and k, v
// (B, Sk, KVH, Dh) and returns cudaGetLastError(), or -1 for a head_dim the
// kernel is not built for. `strides` holds 16 element strides: (b, s, h, d)
// of q, k, v and o in that order. `o` is written, never read.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int seq_q, int seq_k, int n_heads,
                                      int n_kv_heads, int head_dim, float scale,
                                      int causal, int window,
                                      cudaStream_t stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* dst[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int t = 0; t < 4; ++t) {
    dst[t]->b = strides[4 * t + 0];
    dst[t]->s = strides[4 * t + 1];
    dst[t]->h = strides[4 * t + 2];
    dst[t]->d = strides[4 * t + 3];
  }
  p.seq_q = seq_q;
  p.seq_k = seq_k;
  p.group = n_heads / n_kv_heads;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  const int n_qblk = (seq_q + kBlockQ - 1) / kBlockQ;
  if (head_dim == 64) return launch<64>(p, n_qblk, n_heads, batch, stream);
  if (head_dim == 128) return launch<128>(p, n_qblk, n_heads, batch, stream);
  if (head_dim == 256) return launch<256>(p, n_qblk, n_heads, batch, stream);
  return -1;
}
