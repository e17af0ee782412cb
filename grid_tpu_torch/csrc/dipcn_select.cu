// Threshold-bisection dipCN straight from the [N, W] squared-distance
// matrix: for each row, the k nearest columns (ties to the lower column),
// then the first n_nbr usable columns among them, then
// dipcn = rnorm / mean(nbr_w over those), ok = valid & (m_eff > 0).
//
// Replaces grid_tpu/ops/pallas_select.py:dipcn_from_distances_pallas
// (_dipcn_kernel; pallas_call at line 130), and follows its per-row
// structure (pallas_select.py:40-107) step for step.
//
// What bounds it on the H100: each row needs two 31-round bisections on the
// int32 key space and two column tie-cut bisections (12 rounds at N=2504),
// each round a compare-and-count over the whole row: ~86 passes over d2.
// Run as separate tensor passes that is 86 reads of the 25 MB matrix from
// device memory, and a reduction plus a launch per pass.
//
// What the design does about it: one thread block per row. The row's keys
// are copied once into dynamic shared memory, so d2 crosses device memory
// exactly once and every round reads shared memory only. A round ends in
// one block-wide count (warp shuffles, then one shared word per warp), so
// all threads hold the same bisection bounds and leave a search together as
// soon as its interval closes. The usable mask and the w vector are read
// from global memory, where the W-long rows shared by all blocks stay in
// L2. Rows up to the opt-in shared-memory size fit (57,000+ f32 columns
// on an H100; the default 2 GB d2 budget admits N <= 23,170, 92.7 KB).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kExcluded = INT_MAX;  // key of a column outside the usable k-set

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

// Smallest key t with count(keys <= t) >= k (the k-th smallest); 0 when
// k <= 0, which the caller masks.
__device__ int kth_smallest(const int* keys, int w, int k, int* red) {
  int lo = 0, hi = INT_MAX;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    int c = 0;
    for (int j = threadIdx.x; j < w; j += kThreads) c += keys[j] <= mid;
    if (block_sum(c, red) >= k) hi = mid; else lo = mid + 1;
  }
  return hi;
}

__device__ int count_below(const int* keys, int w, int t, int* red) {
  int c = 0;
  for (int j = threadIdx.x; j < w; j += kThreads) c += keys[j] < t;
  return block_sum(c, red);
}

// Smallest column c with count(keys[j] == t for j <= c) >= need; -1 when
// need <= 0 (no ties taken).
__device__ int tie_cut(const int* keys, int w, int t, int need, int* red) {
  if (need <= 0) return -1;
  int lo = 0, hi = w - 1;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    int c = 0;
    for (int j = threadIdx.x; j <= mid; j += kThreads) c += keys[j] == t;
    if (block_sum(c, red) >= need) hi = mid; else lo = mid + 1;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads)
dipcn_select_kernel(const float* __restrict__ d2, const float* __restrict__ rnorm,
                    const float* __restrict__ nbr_w, const uint8_t* __restrict__ usable,
                    const uint8_t* __restrict__ valid, int w, int k, int n_nbr,
                    float* __restrict__ dipcn, uint8_t* __restrict__ ok) {
  extern __shared__ int keys[];  // [w] — the row's keys, then its usable-k-set keys
  __shared__ int red_i[kWarps];
  __shared__ float red_f[kWarps];

  const int row = blockIdx.x;
  // d2 >= 0, so its float32 bit pattern read as int32 keeps the order
  const int* src = reinterpret_cast<const int*>(d2) + static_cast<size_t>(row) * w;
  for (int j = threadIdx.x; j < w; j += kThreads) keys[j] = src[j];
  __syncthreads();

  // --- k-set membership: below t, or at t up to the tie-cut column -------
  const int t = kth_smallest(keys, w, k, red_i);
  const int cut = tie_cut(keys, w, t, k - count_below(keys, w, t, red_i), red_i);

  // --- usable members of the k-set keep their key, the rest are excluded -
  int c = 0;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const int u = keys[j];
    const bool in_k = u < t || (u == t && j <= cut);
    const int uu = (in_k && usable[j]) ? u : kExcluded;
    keys[j] = uu;
    c += uu < kExcluded;
  }
  const int m_eff = min(block_sum(c, red_i), n_nbr);  // block_sum's barrier publishes keys

  // --- the m_eff nearest usable members, same rule ----------------------
  const int t2 = kth_smallest(keys, w, m_eff, red_i);
  const int cut2 = tie_cut(keys, w, t2, m_eff - count_below(keys, w, t2, red_i), red_i);

  float s = 0.f;
  if (m_eff > 0) {
    for (int j = threadIdx.x; j < w; j += kThreads) {
      const int u = keys[j];
      if (u < t2 || (u == t2 && j <= cut2)) s += nbr_w[j];
    }
  }
  const float tot = block_sum(s, red_f);
  if (threadIdx.x == 0) {
    const float nbr_mean = tot / static_cast<float>(max(m_eff, 1));
    dipcn[row] = rnorm[row] / nbr_mean;
    ok[row] = valid[row] && m_eff > 0;
  }
}

}  // namespace

extern "C" {

// Widest row (in float32 columns) one block can hold on `device`; -1 on a
// CUDA error.
int dipcn_select_max_cols(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, dipcn_select_kernel) != cudaSuccess) {
    return -1;
  }
  return static_cast<int>((static_cast<size_t>(optin) - attr.sharedSizeBytes) / sizeof(int));
}

// Launch on `stream` without synchronising; returns the first cudaError_t.
int dipcn_select_launch(const void* d2, const void* rnorm, const void* nbr_w, const void* usable,
                        const void* valid, int n, int w, int k, int n_nbr, void* dipcn, void* ok,
                        void* stream) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(w) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dipcn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dipcn_select_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<const float*>(rnorm),
      static_cast<const float*>(nbr_w), static_cast<const uint8_t*>(usable),
      static_cast<const uint8_t*>(valid), w, k, n_nbr, static_cast<float*>(dipcn),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

const char* dipcn_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
