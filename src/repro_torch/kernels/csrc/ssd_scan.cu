// Mamba2 SSD scan (state-space duality, arXiv:2405.21060 §6) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (body _kernel).  Per head h, with decay a_t = exp(dt_t A_h):
//   S_t = a_t S_{t-1} + B_t ⊗ (dt_t x_t),   y_t = C_t · S_t,   S_{-1} = 0,
// computed in chunks: within a chunk, with cum the running sum of dt A,
//   y_i = Σ_{j<=i} (C_i·B_j) exp(min(cum_i - cum_j, 0)) dt_j x_j      (intra)
//       + exp(cum_i) C_i · S_prev                                      (carried)
//   S  <- exp(seg) S_prev + Σ_j B_j ⊗ (dt_j x_j exp(seg - cum_j))      (update)
// where seg is the chunk's total.  Positions past L get dt = 0 (decay 1,
// no input), so the final state is the state at position L-1.  All
// arithmetic is f32; y is written in x's type, the final state in f32.
//
// Bound on the H100: device memory at the serving shapes.  At B = 1,
// L = 1024, H = 32, P = 64, N = 128 the function reads x, dt, A, B, C and
// writes y and the final state once: ~10 MB, ~3 µs at 3.35 TB/s.  The
// least arithmetic (the recurrence: ~4 L H N P flops, 1.1 GFLOP) takes
// ~2 µs even at the TF32 tensor-core rate.  This kernel does the chunked
// algorithm in scalar f32 FMAs (67 TFLOP/s), ~1.6 GFLOP at L = 1024, so its
// own floor is ~24 µs: a simple, exact first version; wgmma/TMA are later
// work.
//
// Design, translated from the TPU kernel rather than carried over:
//  * The TPU walks chunks IN ORDER on a sequential grid axis and carries S
//    in VMEM.  Here the chunk dimension is made parallel by splitting the
//    work into three launches on one stream (the kernel picks its own tile
//    of kT = 64 positions; SSD chunking is exact algebra at any tile):
//      1. ssd_tile_state, one CTA per (tile, h, b): the tile's own state
//         Σ_j B_j ⊗ (dt_j x_j exp(seg - cum_j)) and its seg, to scratch;
//      2. ssd_state_pass, one thread per (b, h, n, p): the recurrence over
//         tiles, S <- exp(seg) S + S_tile, which overwrites each tile's
//         state with the state before it (S_prev) and writes the final
//         state;
//      3. ssd_tile_out, one CTA per (tile, h, b): y = intra + carried.
//    At B = 1, H = 32, L = 1024 that is 512 CTAs per tile-parallel launch,
//    where one CTA per (b, h) walking the tiles would leave 100 SMs idle.
//  * cum is a per-tile running sum (a warp scan), so it stays small; only
//    differences of cum and (seg - cum) <= 0 are exponentiated, never
//    exp(cum_i) exp(-cum_j), so nothing overflows.  exp(cum_i) underflowing
//    to 0 along a fast-decaying head is the right value.
//  * Products run on 256 threads as 16 x 16, each thread owning a register
//    tile of rows ty + 16 r and 4-wide column groups; C and B tiles sit in
//    shared memory with rows padded to N + 4 floats, so the 16-byte loads
//    of neighbouring rows fall in distinct banks.  The carried state S_prev
//    reuses B's shared memory once C·Bᵀ is done (99 KB at N = 128, P = 64:
//    two CTAs per SM).
// B and C are one group (G = 1), as the TPU kernel asserts; N and P are
// multiples of 4 and at most 128 (the wrapper ops.ssd_scan checks).
#include "common.cuh"

namespace {

constexpr int kT = 64;  // positions per tile
constexpr int kThreads = 256;
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kRows = kT / 16;  // rows of the (i, j) and (i, p) register tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dt of the tile's positions (0 past L) into dts and the running sum of
// dt * A into cum; threads 0..kT-1 (two full warps) take one position each.
__device__ __forceinline__ void tile_decay(const float* __restrict__ dt, float a, int b, int h,
                                           int t0, int L, int H, float* dts, float* cum) {
  const int i = threadIdx.x;
  if (i < kT) {
    const int pos = t0 + i;
    const float d = pos < L ? dt[(static_cast<size_t>(b) * L + pos) * H + h] : 0.f;
    dts[i] = d;
    float c = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, c, o);
      if ((i & 31) >= o) c += up;
    }
    cum[i] = c;
  }
  __syncthreads();
  if (i >= 32 && i < kT) cum[i] += cum[31];
  __syncthreads();
}

// rows [t0, t0 + kT) of src [.., L, .., width] (row stride `stride`) into
// dst [kT][ld] as f32, zeros past L.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, size_t stride, int t0, int L,
                                          int width, float* dst, int ld) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int j = e / width, c = e % width;
    const int pos = t0 + j;
    dst[j * ld + c] = pos < L ? rt::to_f32(src[static_cast<size_t>(pos) * stride + c]) : 0.f;
  }
}

// 1. The tile's own state S_tile[n][p] = Σ_j B[j][n] dt_j x[j][p] exp(seg - cum_j).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_tile_state(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, float* __restrict__ states, float* __restrict__ segs,
               int L, int H, int P, int N, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;            // [kT]
  float* cum = dts + kT;        // [kT]
  float* Bs = cum + kT;         // [kT][N]
  float* xw = Bs + kT * N;      // [kT][P]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kT;
  tile_decay(dt, A[h], b, h, t0, L, H, dts, cum);
  const float seg = cum[kT - 1];
  load_rows(Bm + static_cast<size_t>(b) * L * N, N, t0, L, N, Bs, N);
  for (int e = threadIdx.x; e < kT * P; e += kThreads) {
    const int j = e / P, p = e % P;
    const int pos = t0 + j;
    xw[e] = pos < L ? rt::to_f32(x[((static_cast<size_t>(b) * L + pos) * H + h) * P + p]) *
                          dts[j] * expf(seg - cum[j])
                    : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* out = states + ((static_cast<size_t>(b) * n_tiles + c) * H + h) * N * P;
  for (int g = tx; g < P / 4; g += 16) {
    float acc[kMaxN / 16][4] = {};
    for (int j = 0; j < kT; ++j) {
      const float4 xv = ld4(xw + j * P + 4 * g);
#pragma unroll
      for (int r = 0; r < kMaxN / 16; ++r) {
        if (ty + 16 * r < N) {
          const float bv = Bs[j * N + ty + 16 * r];
          acc[r][0] = fmaf(bv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(bv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(bv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(bv, xv.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxN / 16; ++r) {
      if (ty + 16 * r < N)
        *reinterpret_cast<float4*>(out + (ty + 16 * r) * P + 4 * g) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  if (threadIdx.x == 0) segs[(static_cast<size_t>(b) * n_tiles + c) * H + h] = seg;
}

// 2. The recurrence over tiles, one (b, h, n, p) element per thread:
// states[b, c] becomes the state before tile c; final = the state after all.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ segs,
               float* __restrict__ final_state, int B, int H, int NP, int n_tiles) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * H * NP) return;
  const int b = static_cast<int>(idx / (static_cast<size_t>(H) * NP));
  const int h = static_cast<int>(idx / NP % H);
  const size_t stride = static_cast<size_t>(H) * NP;  // one tile
  float* s = states + static_cast<size_t>(b) * n_tiles * stride + idx % stride;
  const float* sg = segs + static_cast<size_t>(b) * n_tiles * H + h;
  float S = 0.f;
  float next = s[0];
  for (int c = 0; c < n_tiles; ++c) {
    const float own = next;
    if (c + 1 < n_tiles) next = s[(c + 1) * stride];
    s[c * stride] = S;
    S = fmaf(S, expf(sg[c * H]), own);
  }
  final_state[idx] = S;
}

// 3. y for the tile: intra-tile term plus the carried state's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_tile_out(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
             const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states,
             T* __restrict__ y, int L, int H, int P, int N, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 4;                        // padded row of C and B
  float* dts = smem;                           // [kT]
  float* cum = dts + kT;                       // [kT]
  float* Cs = cum + kT;                        // [kT][ld]
  float* xdt = Cs + kT * ld;                   // [kT][P]
  float* Ms = xdt + kT * P;                    // [kT][kT]
  float* Bs = Ms + kT * kT;                    // [kT][ld], then S_prev [N][P]
  float* Sp = Bs;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  tile_decay(dt, A[h], b, h, t0, L, H, dts, cum);
  load_rows(Cm + static_cast<size_t>(b) * L * N, N, t0, L, N, Cs, ld);
  load_rows(Bm + static_cast<size_t>(b) * L * N, N, t0, L, N, Bs, ld);
  for (int e = threadIdx.x; e < kT * P; e += kThreads) {
    const int j = e / P, p = e % P;
    const int pos = t0 + j;
    xdt[e] = pos < L ? rt::to_f32(x[((static_cast<size_t>(b) * L + pos) * H + h) * P + p]) * dts[j]
                     : 0.f;
  }
  __syncthreads();

  // M[i][j] = (C_i · B_j) exp(min(cum_i - cum_j, 0)) for j <= i, else 0
  {
    float acc[kRows][kRows] = {};
    for (int n = 0; n < N; n += 4) {
      float4 cv[kRows], bv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        cv[r] = ld4(Cs + (ty + 16 * r) * ld + n);
        bv[r] = ld4(Bs + (tx + 16 * r) * ld + n);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kRows; ++s)
          acc[r][s] = fmaf(cv[r].x, bv[s].x,
                           fmaf(cv[r].y, bv[s].y,
                                fmaf(cv[r].z, bv[s].z, fmaf(cv[r].w, bv[s].w, acc[r][s]))));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        const int i = ty + 16 * r, j = tx + 16 * s;
        Ms[i * kT + j] = j <= i ? acc[r][s] * expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
      }
  }
  __syncthreads();  // B is no longer read: its space takes S_prev
  const float* prev = states + ((static_cast<size_t>(b) * n_tiles + c) * H + h) * N * P;
  for (int e = threadIdx.x; e < N * P / 4; e += kThreads)
    reinterpret_cast<float4*>(Sp)[e] = reinterpret_cast<const float4*>(prev)[e];
  __syncthreads();

  for (int g = tx; g < P / 4; g += 16) {
    float intra[kRows][4] = {}, inter[kRows][4] = {};
    for (int j = 0; j < kT; ++j) {
      const float4 xv = ld4(xdt + j * P + 4 * g);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float m = Ms[(ty + 16 * r) * kT + j];
        intra[r][0] = fmaf(m, xv.x, intra[r][0]);
        intra[r][1] = fmaf(m, xv.y, intra[r][1]);
        intra[r][2] = fmaf(m, xv.z, intra[r][2]);
        intra[r][3] = fmaf(m, xv.w, intra[r][3]);
      }
    }
    for (int n = 0; n < N; ++n) {
      const float4 sv = ld4(Sp + n * P + 4 * g);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float cv = Cs[(ty + 16 * r) * ld + n];
        inter[r][0] = fmaf(cv, sv.x, inter[r][0]);
        inter[r][1] = fmaf(cv, sv.y, inter[r][1]);
        inter[r][2] = fmaf(cv, sv.z, inter[r][2]);
        inter[r][3] = fmaf(cv, sv.w, inter[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ty + 16 * r;
      const int pos = t0 + i;
      if (pos >= L) continue;
      const float decay = expf(cum[i]);
      T* yr = y + ((static_cast<size_t>(b) * L + pos) * H + h) * P + 4 * g;
#pragma unroll
      for (int k = 0; k < 4; ++k) yr[k] = rt::from_f32<T>(intra[r][k] + decay * inter[r][k]);
    }
  }
}

size_t state_smem(int P, int N) { return sizeof(float) * (2 * kT + kT * N + kT * P); }

size_t out_smem(int P, int N) {
  const size_t ld = N + 4;
  const size_t shared_bs = kT * ld > static_cast<size_t>(N) * P ? kT * ld : static_cast<size_t>(N) * P;
  return sizeof(float) * (2 * kT + kT * ld + kT * P + kT * kT + shared_bs);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm, void* y,
           float* final_state, float* states, float* segs, int B, int L, int H, int P, int N,
           cudaStream_t s) {
  const int n_tiles = (L + kT - 1) / kT;
  const dim3 grid(n_tiles, H, B);
  const size_t smem1 = state_smem(P, N), smem3 = out_smem(P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_tile_state<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_tile_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_tile_state<T><<<grid, kThreads, smem1, s>>>(static_cast<const T*>(x), dt, A,
                                                  static_cast<const T*>(Bm), states, segs, L, H,
                                                  P, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elems = static_cast<size_t>(B) * H * N * P;
  ssd_state_pass<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      states, segs, final_state, B, H, N * P, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tile_out<T><<<grid, kThreads, smem3, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      states, static_cast<T*>(y), L, H, P, N, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B, L, H, P] (x's type); dt: [B, L, H] f32; A: [H] f32; Bm, Cm:
// [B, L, 1, N] (x's type); final_state: [B, H, N, P] f32; scratch states:
// [B, n_tiles, H, N, P] f32 and segs: [B, n_tiles, H] f32, where n_tiles
// must be ceil(L / 64) (the caller sized them).  All contiguous; N, P
// multiples of 4, at most 128.  Returns a cudaError_t.
extern "C" int rt_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, void* y, void* final_state, void* states, void* segs,
                           int n_tiles, int B, int L, int H, int P, int N, int dtype,
                           void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || P % 4 || N % 4 || P > kMaxP ||
      N > kMaxN || n_tiles != (L + kT - 1) / kT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* fs = static_cast<float*>(final_state);
  float* st = static_cast<float*>(states);
  float* sg = static_cast<float*>(segs);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, fs, st, sg, B, L, H, P, N, s);
  if (dtype == rt::kF32) return launch<float>(x, dtf, Af, Bm, Cm, y, fs, st, sg, B, L, H, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
