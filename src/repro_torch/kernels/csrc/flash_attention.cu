// Prefill flash attention (GQA, optional causal mask) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel):
// blocked online softmax with running (acc, m, l) in f32, l floored at
// 1e-30, NEG_INF = -2e30, a kv-padding mask (kpos >= Sk) and an optional
// causal mask; q-head h reads kv-head h / G.
//
// Bound on the H100: operations.  At the prefill shapes (Sq = Sk up to
// 1024, head_dim 128) each K/V byte is used by a whole q-block, so the work
// is ~Sq/2 multiply-adds per byte read: the tensor cores' rate bounds it.
//
// Design, translated from the TPU kernel rather than carried over:
//  * The TPU walks KV blocks on a sequential grid axis and carries
//    (acc, m, l) in VMEM scratch.  Here one CTA owns one (b, h, 64-row
//    q-block) and a loop inside it walks KV tiles; the running state lives
//    in registers.  The loop stops at the causal limit, which is the TPU's
//    block skip for free.  Heavy (late) q-blocks are scheduled first.
//  * bf16 at head_dim 128 (the serving path) takes flash_fwd_wmma:
//    4 warps, each owning 16 q rows, with S = Q K^T and P V on the tensor
//    cores through WMMA (16x16x16 bf16 -> f32, mma.sync underneath).  Q's
//    fragments stay in registers for the whole KV loop; K, V (64-row tiles),
//    the f32 scores, the bf16 probabilities and the f32 P V tile sit in
//    shared memory (93 KB at head_dim 128, above the 48 KB default, so the
//    launcher raises the limit).  The online softmax and the rescale of
//    the output rows run in f32 registers, two lanes per row.  P is rounded
//    to bf16 for its product with V (the TPU kernel keeps it in f32); l
//    sums the f32 values.  wgmma, TMA and warp specialisation are later
//    work.
//  * Any other case (f32, other head_dims <= 128) takes flash_fwd, scalar
//    f32 FMAs: 256 threads as 16 x 16, thread (ty, tx) owning q rows
//    4ty..4ty+3, key columns tx and tx+16 of a 32-row KV tile and output
//    columns tx + 16j, with Q (pre-scaled, as the TPU kernel scales q in
//    f32), K, V and P in shared memory as f32.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kColsPerThread = kMaxDh / 16;

size_t smem_bytes(int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * Dh + kBK * (Dh + 1) + kBK * Dh + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Sk, int H, int KH, int Dh, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][Dh]
  float* Ks = Qs + kBQ * Dh;             // [kBK][Dh + 1]
  float* Vs = Ks + kBK * (Dh + 1);       // [kBK][Dh]
  float* Ps = Vs + kBK * Dh;             // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;  // late (heavier) causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * kBQ;
  const size_t q_row = static_cast<size_t>(H) * Dh;
  const size_t kv_row = static_cast<size_t>(KH) * Dh;
  const T* qbase = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * Dh;
  const T* kbase = k + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kh) * Dh;
  const T* vbase = v + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kh) * Dh;
  T* obase = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * Dh;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh, qp = q0 + r;
    Qs[i] = qp < Sq ? rt::to_f32(qbase[qp * q_row + d]) * scale : 0.f;
  }

  float acc[4][kColsPerThread];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K/V reads are done (and Q is stored)
    for (int i = tid; i < kBK * Dh; i += kThreads) {
      const int r = i / Dh, d = i % Dh, kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = rt::to_f32(kbase[kp * kv_row + d]);
        vv = rt::to_f32(vbase[kp * kv_row + d]);
      }
      Ks[r * (Dh + 1) + d] = kv;
      Vs[r * Dh + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float k_a = Ks[tx * (Dh + 1) + d];
      const float k_b = Ks[(tx + 16) * (Dh + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qq = Qs[(ty * 4 + i) * Dh + d];
        s[i][0] = fmaf(qq, k_a, s[i][0]);
        s[i][1] = fmaf(qq, k_b, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Sk || (causal && kp > qp)) s[i][j] = rt::kNegInf;
      }
      const float m_new = fmaxf(m[i], rt::lanes_max<16>(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + rt::lanes_sum<16>(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] *= alpha;
      Ps[r * (kBK + 1) + tx] = p0;
      Ps[r * (kBK + 1) + tx + 16] = p1;
    }
    __syncwarp();

    for (int c = 0; c < kBK; ++c) {
      float vv[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = tx + 16 * j;
        vv[j] = col < Dh ? Vs[c * Dh + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pp = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(pp, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = tx + 16 * j;
      if (col < Dh) obase[qp * q_row + col] = rt::from_f32<T>(acc[i][j] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, head_dim DH = 128
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kWBQ = 64;       // q rows per CTA (16 per warp)
constexpr int kWBK = 64;       // kv rows per tile
constexpr int kWThreads = 128;

template <int DH>
struct WmmaTiles {
  static constexpr int LDQ = DH + 8;       // bf16 Q/K/V rows
  static constexpr int LDS = kWBK + 4;     // f32 scores
  static constexpr int LDP = kWBK + 8;     // bf16 probabilities
  static constexpr int LDO = DH + 4;       // f32 P V tile
  static constexpr int LDR = LDS > LDO ? LDS : LDO;  // a warp's score / P V rows
  static constexpr size_t kQ = sizeof(bf16) * kWBQ * LDQ;
  static constexpr size_t kKV = sizeof(bf16) * kWBK * LDQ;
  static constexpr size_t kR = sizeof(float) * kWBQ * LDR;
  static constexpr size_t kP = sizeof(bf16) * kWBQ * LDP;
  static constexpr size_t kBytes = kQ + 2 * kKV + kR + kP;
};

// rows [0, 64) of a [*, H or KH, DH] bf16 tensor starting at `row0`, zero
// past `n_rows`, into shared memory with leading dimension LDQ
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t row_stride,
                                          int row0, int n_rows) {
  constexpr int kVecs = DH / 8;
  for (int i = threadIdx.x; i < 64 * kVecs; i += kWThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c));
    *reinterpret_cast<uint4*>(dst + r * WmmaTiles<DH>::LDQ + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kWThreads)
flash_fwd_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk, int H,
               int KH, float scale, int causal) {
  using Tl = WmmaTiles<DH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + Tl::kQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + Tl::kQ + Tl::kKV);
  float* Rs = reinterpret_cast<float*>(smem_raw + Tl::kQ + 2 * Tl::kKV);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + Tl::kQ + 2 * Tl::kKV + Tl::kR);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qb = gridDim.x - 1 - blockIdx.x;  // late (heavier) causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qb * kWBQ;
  const size_t q_row = static_cast<size_t>(H) * DH;
  const size_t kv_row = static_cast<size_t>(KH) * DH;
  const bf16* qbase = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * DH;
  const bf16* kbase = k + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kh) * DH;
  const bf16* vbase = v + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kh) * DH;

  load_tile<DH>(Qs, qbase, q_row, q0, Sq);
  __syncthreads();
  wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wm::load_matrix_sync(qf[kk], Qs + warp * 16 * Tl::LDQ + kk * 16, Tl::LDQ);

  float* Rw = Rs + warp * 16 * Tl::LDR;   // this warp's scores, then its P V tile
  bf16* Pw = Ps + warp * 16 * Tl::LDP;
  const int r = lane / 2, half = lane % 2;  // lane's row of the warp's 16, its half
  const int qp = q0 + warp * 16 + r;
  float m = rt::kNegInf, l = 0.f;
  float oacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + kWBQ) : Sk;
  const int n_tiles = (kv_end + kWBK - 1) / kWBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kWBK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<DH>(Ks, kbase, kv_row, k0, Sk);
    load_tile<DH>(Vs, vbase, kv_row, k0, Sk);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kWBK / 16; ++j) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> sf;
      wm::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kf;
        wm::load_matrix_sync(kf, Ks + j * 16 * Tl::LDQ + kk * 16, Tl::LDQ);
        wm::mma_sync(sf, qf[kk], kf, sf);
      }
      wm::store_matrix_sync(Rw + j * 16, sf, Tl::LDS, wm::mem_row_major);
    }
    __syncwarp();

    float sv[kWBK / 2];
    float mx = rt::kNegInf;
#pragma unroll
    for (int c = 0; c < kWBK / 2; ++c) {
      const int col = half * (kWBK / 2) + c, kp = k0 + col;
      float s = Rw[r * Tl::LDS + col] * scale;
      if (kp >= Sk || (causal && kp > qp)) s = rt::kNegInf;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < kWBK / 2; ++c) {
      const float p = expf(sv[c] - m_new);
      rs += p;
      Pw[r * Tl::LDP + half * (kWBK / 2) + c] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> of;
      wm::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pf;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf;
        wm::load_matrix_sync(pf, Pw + kk * 16, Tl::LDP);
        wm::load_matrix_sync(vf, Vs + kk * 16 * Tl::LDQ + c * 16, Tl::LDQ);
        wm::mma_sync(of, pf, vf, of);
      }
      wm::store_matrix_sync(Rw + c * 16, of, Tl::LDO, wm::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i)
      oacc[i] = fmaf(oacc[i], alpha, Rw[r * Tl::LDO + half * (DH / 2) + i]);
    __syncwarp();  // the next tile's scores overwrite Rw
  }

  if (qp < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    bf16* orow = o + static_cast<size_t>(b) * Sq * q_row + qp * q_row +
                 static_cast<size_t>(h) * DH + half * (DH / 2);
#pragma unroll
    for (int i = 0; i < DH / 2; i += 8) {
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = oacc[i + e] / denom;
      rt::store_vec(orow + i, out);
    }
  }
}

template <int DH>
int launch_wmma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int H, int KH, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = WmmaTiles<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kWBQ - 1) / kWBQ, H, B);
  flash_fwd_wmma<DH><<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, KH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Scalar path: any dtype, head_dim <= 128
// ---------------------------------------------------------------------------

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KH, int Dh, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, Sq, H, Dh]; k, v: [B, Sk, KH, Dh]; all contiguous, Dh <= 128,
// H % KH == 0.  Returns a cudaError_t (0 on success).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int Sq, int Sk, int H, int KH, int Dh, float scale, int causal,
                                  int dtype, void* stream) {
  if (Dh > kMaxDh || Dh <= 0 || KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16 && Dh == 128)
    return launch_wmma<128>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
  if (dtype == rt::kBF16) return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, Dh, scale, causal, s);
  if (dtype == rt::kF32) return launch<float>(q, k, v, o, B, Sq, Sk, H, KH, Dh, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
