// Decode attention (one new token per sequence over a KV cache) for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _kernel):
// the G q-heads of a kv-head share each cache tile, positions >= lens[b]
// are masked, the softmax runs online in f32, and lens[b] == 0 gives zeros.
//
// Bound on the H100: device memory.  Every cache byte up to lens[b] is read
// once for ~1 multiply-add per q-head sharing it (G = 5 at qwen3-14b), so
// the kernel has to spread the cache read over the whole card and keep many
// loads in flight.
//
// Design, translated from the TPU kernel rather than carried over:
//  * The TPU walks the cache on a sequential grid axis of one core.  One
//    CTA per (b, kv-head) would use 32 of the 132 SMs at B = 4, KH = 8, so
//    the cache is also split along S into chunks of `chunk` positions
//    (split-K flash decoding): pass 1 gives each (chunk, kv-head, b) a CTA
//    that writes its partial (acc, m, l) in f32; pass 2 merges the chunks
//    with a log-sum-exp combine.  At S = 2048, chunk 128 that is 512 CTAs.
//  * lens stays on the device: each CTA reads lens[b] itself and a chunk
//    that starts past it writes an empty partial (m = NEG_INF, l = 0) and
//    stops, so no host sync and no cache byte past lens[b] is read.
//  * A cache row (head_dim values) is read by a team of TPR threads with
//    one 16-byte load each (TPR = 16 for bf16 at head_dim 128), so a CTA of
//    128 threads reads 8 rows per step.  Scores: each thread dots its slice
//    of the row with the G q-heads (from shared memory) and the team sums
//    by shuffles.  P·V: each thread accumulates its slice for every head
//    over the rows of its team; the 8 teams are summed in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;

template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
               const int* __restrict__ lens, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int S, int H, int KH, int chunk, float scale) {
  constexpr int V = rt::kVec<T>;
  constexpr int Dh = TPR * V;
  constexpr int kTeams = kThreads / TPR;  // cache rows per step
  extern __shared__ float smem[];
  const int G = H / KH;
  float* qs = smem;                  // [G][Dh], pre-scaled
  float* ps = qs + G * Dh;           // [G][chunk]: scores, then probabilities
  float* red = ps + G * chunk;       // [kTeams][G][Dh]: per-team P·V partials
  __shared__ float m_sh[kMaxG], l_sh[kMaxG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = tid % TPR, team = tid / TPR;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int len = min(max(lens[b], 0), S);
  const int s0 = split * chunk;
  const int n = min(s0 + chunk, len) - s0;  // valid positions in this chunk
  const size_t part = (static_cast<size_t>(b) * KH + kh) * n_split + split;  // x G heads
  float* acc_out = part_acc + part * G * Dh;
  float* ml_out = part_ml + part * G * 2;

  if (n <= 0) {
    for (int i = tid; i < G * Dh; i += kThreads) acc_out[i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      ml_out[2 * g] = rt::kNegInf;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) qs[i] = rt::to_f32(qb[i]) * scale;
  __syncthreads();

  const size_t row = static_cast<size_t>(KH) * Dh;
  const T* kb = kc + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * Dh + sub * V;
  const T* vb = vc + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * Dh + sub * V;

  // scores: the loop bound is uniform over the CTA, so every lane reaches
  // the team shuffles; rows past n load nothing and store nothing
  for (int base = 0; base < n; base += kTeams) {
    const int i = base + team;
    float kf[V];
    if (i < n) {
      rt::load_vec(kb + (s0 + i) * row, kf);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) kf[e] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * Dh + sub * V;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) d = fmaf(qg[e], kf[e], d);
      d = rt::lanes_sum<TPR>(d);
      if (sub == 0 && i < n) ps[g * chunk + i] = d;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = rt::kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[g * chunk + i]);
    mx = rt::lanes_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(ps[g * chunk + i] - mx);
      ps[g * chunk + i] = e;
      sum += e;
    }
    sum = rt::lanes_sum(sum);
    if (lane == 0) {
      m_sh[g] = mx;
      l_sh[g] = sum;
    }
  }
  __syncthreads();

  float acc[kMaxG][V];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  for (int i = team; i < n; i += kTeams) {
    float vf[V];
    rt::load_vec(vb + (s0 + i) * row, vf);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float p = ps[g * chunk + i];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(team * G + g) * Dh + sub * V + e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < G * Dh; idx += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kTeams; ++t) s += red[t * G * Dh + idx];
    acc_out[idx] = s;
  }
  for (int g = tid; g < G; g += kThreads) {
    ml_out[2 * g] = m_sh[g];
    ml_out[2 * g + 1] = l_sh[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               T* __restrict__ out, int H, int KH, int Dh, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KH, kh = h / G, g = h % G;
  const size_t first = (static_cast<size_t>(b) * KH + kh) * n_split;  // partial of split 0
  float M = rt::kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[((first + s) * G + g) * 2]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + ((first + s) * G + g) * 2;
    L += expf(ml[0] - M) * ml[1];
  }
  L = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += expf(part_ml[((first + s) * G + g) * 2] - M) * part_acc[((first + s) * G + g) * Dh + d];
    out[(static_cast<size_t>(b) * H + h) * Dh + d] = rt::from_f32<T>(a / L);
  }
}

template <typename T, int TPR>
int launch(const void* q, const void* kc, const void* vc, const int* lens, void* out,
           float* part_acc, float* part_ml, int B, int S, int H, int KH, int chunk, float scale,
           cudaStream_t stream) {
  constexpr int Dh = TPR * rt::kVec<T>;
  const int G = H / KH;
  const int n_split = (S + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * static_cast<size_t>(G) *
                      (Dh + chunk + (kThreads / TPR) * Dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_partial<T, TPR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_partial<T, TPR><<<dim3(n_split, KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lens,
      part_acc, part_ml, S, H, KH, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<dim3(H, B), kThreads, 0, stream>>>(part_acc, part_ml, static_cast<T*>(out),
                                                        H, KH, Dh, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const int* lens, void* out,
             float* pa, float* pm, int B, int S, int H, int KH, int Dh, int chunk, float scale,
             cudaStream_t s) {
  switch (Dh / rt::kVec<T>) {  // threads per cache row, one 16-byte load each
    case 4: return launch<T, 4>(q, kc, vc, lens, out, pa, pm, B, S, H, KH, chunk, scale, s);
    case 8: return launch<T, 8>(q, kc, vc, lens, out, pa, pm, B, S, H, KH, chunk, scale, s);
    case 16: return launch<T, 16>(q, kc, vc, lens, out, pa, pm, B, S, H, KH, chunk, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, lens, out, pa, pm, B, S, H, KH, chunk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [B, H, Dh]; k_cache, v_cache: [B, S, KH, Dh]; lens: [B] int32 on
// the device; Dh * sizeof(T) in {64, 128, 256, 512} bytes; H / KH <= 8.
// part_acc: [B, KH, n_split, G, Dh] f32 and part_ml: [B, KH, n_split, G, 2]
// f32 scratch with n_split = ceil(S / chunk).  Returns a cudaError_t.
extern "C" int rt_decode_attention(const void* q, const void* kc, const void* vc,
                                   const void* lens, void* out, void* part_acc, void* part_ml,
                                   int B, int S, int H, int KH, int Dh, int chunk, float scale,
                                   int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxG || chunk <= 0 || Dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == rt::kBF16 && Dh % rt::kVec<__nv_bfloat16> == 0)
    return dispatch<__nv_bfloat16>(q, kc, vc, ln, out, pa, pm, B, S, H, KH, Dh, chunk, scale, s);
  if (dtype == rt::kF32 && Dh % rt::kVec<float> == 0)
    return dispatch<float>(q, kc, vc, ln, out, pa, pm, B, S, H, KH, Dh, chunk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
