// G = P * P^T with P = where(mask, clip(z, -zmax, zmax), 0) * region, for
// z [N, R] float32: the Gram matrix of the prepared z rows, from which the
// cohort step's squared distances follow.
//
// Replaces grid_tpu/ops/pallas_kernels.py:zprep_gram (_zprep_tile and
// _gram_kernel; pallas_call at line 93).
//
// What bounds it on the H100: 2*N*N*R flops (25.7 GFLOP at N=2504,
// R=2048) against only N*R*5 bytes of input, so it is compute-bound. The
// neighbor lists must be identical to the float32 reference, so the
// product runs in plain float32 FMA on the CUDA cores (no TF32 tensor
// cores, which keep ~10 mantissa bits), whose peak is ~67 TFLOP/s.
//
// What the design does about it: a classic register-blocked SGEMM. Each
// block of 256 threads owns a 128x128 tile of G; each thread accumulates an
// 8x8 sub-tile in registers, so every shared-memory value it reads feeds 8
// FMAs. The clip, mask and region multiply happen as each z tile is loaded
// into shared memory, so P is never written to device memory. The loop over
// R inside the block takes the place of the Pallas grid's sequential r
// axis. Ragged edges (N, R not multiples of the tile) are masked in the
// loads and the stores; nothing is padded. Symmetry of G, wgmma and TMA are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // rows and columns of G per block
constexpr int kDepth = 8;     // R columns per shared-memory stage
constexpr int kThreads = 256;

__device__ __forceinline__ float prep(const float* __restrict__ z, const uint8_t* __restrict__ mask,
                                      const uint8_t* __restrict__ region, int n, int r, int row,
                                      int col, float zmax) {
  if (row >= n || col >= r) return 0.f;
  const size_t off = static_cast<size_t>(row) * r + col;
  if (!mask[off] || !region[col]) return 0.f;
  return fminf(fmaxf(z[off], -zmax), zmax);
}

__global__ void __launch_bounds__(kThreads)
zprep_gram_kernel(const float* __restrict__ z, const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ region, float zmax, int n, int r,
                  float* __restrict__ g) {
  // stored k-major so a thread's 4 consecutive rows are one float4 read
  __shared__ __align__(16) float a_tile[kDepth][kTile];
  __shared__ __align__(16) float b_tile[kDepth][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // this thread's columns: tx*4..+3 and 64+tx*4..+3
  const int ty = tid / 16;  // this thread's rows:    ty*4..+3 and 64+ty*4..+3
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int load_row = tid / 2;        // each thread loads 4 depth values
  const int load_k = (tid % 2) * 4;    // of one row of each tile

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < r; k0 += kDepth) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = k0 + load_k + q;
      a_tile[load_k + q][load_row] = prep(z, mask, region, n, r, row0 + load_row, col, zmax);
      b_tile[load_k + q][load_row] = prep(z, mask, region, n, r, col0 + load_row, col, zmax);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_tile[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_tile[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_tile[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_tile[kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < n) g[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` without synchronising; returns the launch's cudaError_t.
int zprep_gram_launch(const void* z, const void* mask, const void* region, float zmax, int n,
                      int r, void* g, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int tiles = (n + kTile - 1) / kTile;
  zprep_gram_kernel<<<dim3(tiles, tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(region), zmax, n, r, static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

const char* zprep_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
