// Fused RMSNorm for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (body _kernel): f32 upcast, mean of squares, rsqrt(var + eps), scale by
// w, cast back to x's type, in one pass over each row.
//
// Bound on the H100: device memory.  It reads x and w once and writes y
// once (about 0.5 flop per byte, far below the card's ~20 f32 flop per
// byte), so the design reads each row once, with 16-byte vector loads, and
// keeps it in registers between the sum of squares and the scaled write.
//  * Rows of up to 128 vectors (the q/k norms over head_dim 128: 16
//    vectors) go to a team of TPR <= 32 lanes of one warp, 256 / TPR rows
//    per block; the sum is a team-wide shuffle reduction.
//  * Longer rows (d_model 5120: 640 vectors) get a block of 256 threads
//    each; warp shuffles, then the eight warp sums through shared memory.
// The wrapper (ops.rmsnorm) checks that D fills whole 16-byte vectors and
// that x, w and y are 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One row per team of TPR threads; each thread holds up to VPT vectors.
template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
             int D, float eps) {
  constexpr int V = rt::kVec<T>;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const bool live = row < rows;  // no early return: the team reduction is warp-wide
  const int n_vec = D / V;
  const T* xr = x + static_cast<size_t>(row) * D;
  float v[VPT][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = sub + j * TPR;
    if (live && c < n_vec) {
      rt::load_vec(xr + c * V, v[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(v[j][e], v[j][e], ss);
    }
  }
  if constexpr (TPR <= 32) {
    ss = rt::lanes_sum<TPR>(ss);
  } else {
    __shared__ float partial[TPR / 32];
    ss = rt::lanes_sum(ss);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) ss += partial[i];
  }
  const float r = rsqrtf(ss / D + eps);
  T* yr = y + static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = sub + j * TPR;
    if (live && c < n_vec) {
      float wv[V], out[V];
      rt::load_vec(w + c * V, wv);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = v[j][e] * r * wv[e];
      rt::store_vec(yr + c * V, out);
    }
  }
}

template <typename T, int TPR, int VPT>
void launch_rows(const T* x, const T* w, T* y, int rows, int D, float eps, cudaStream_t s) {
  constexpr int per_block = kThreads / TPR;
  rmsnorm_rows<T, TPR, VPT><<<(rows + per_block - 1) / per_block, kThreads, 0, s>>>(
      x, w, y, rows, D, eps);
}

template <typename T>
int launch(const void* xv, const void* wv, void* yv, int rows, int D, float eps,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  const int n_vec = D / rt::kVec<T>;
  if (n_vec <= 4) launch_rows<T, 4, 1>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 8) launch_rows<T, 8, 1>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 16) launch_rows<T, 16, 1>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 32) launch_rows<T, 32, 1>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 64) launch_rows<T, 32, 2>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 128) launch_rows<T, 32, 4>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 256) launch_rows<T, kThreads, 1>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 512) launch_rows<T, kThreads, 2>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 1024) launch_rows<T, kThreads, 4>(x, w, y, rows, D, eps, s);
  else if (n_vec <= 2048) launch_rows<T, kThreads, 8>(x, w, y, rows, D, eps, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, D] contiguous; w: [D]; D a multiple of 16 bytes' worth of
// elements, at most 2048 such vectors.  Returns a cudaError_t (0 on success).
extern "C" int rt_rmsnorm(const void* x, const void* w, void* y, int rows, int D, float eps,
                          int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16 && D % rt::kVec<__nv_bfloat16> == 0)
    return launch<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  if (dtype == rt::kF32 && D % rt::kVec<float> == 0)
    return launch<float>(x, w, y, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
