// The FP64 tensor-core mma shapes of sm_90, alone: mma.sync.aligned
// m8n8k4 (sm_80's only f64 shape), m16n8k4, m16n8k8 and m16n8k16, all
// .row.col.f64.f64.f64.f64. Built and driven by scripts/dmma_shapes.py.
//
// - dmma_throughput: every warp runs `iters` rounds of kChains independent
//   mma chains on fragments held in registers: no memory traffic but the
//   final store of a checksum, so the time is the tensor pipe's alone.
// - dmma_layout: one warp loads A [M, K] and B as [N, K] (both row-major in
//   device memory) into the fragments of csrc/zprep_gram64.cu's note (for
//   m8n8k4: lane l holds A[l/4][l%4], B[l%4][l/4], D[l/4][2(l%4) + e]),
//   runs one mma on a zero accumulator and stores D [M, N], so the caller
//   can hold the layouts to a product computed on the host.
//
// Shapes are named by their K, with 0 for m8n8k4.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;  // independent accumulators a warp

template <int K_>
struct Shape {  // m16n8kK
  static constexpr int M = 16, K = K_, A = K_ / 2, B = K_ / 4, D = 4;
};
template <>
struct Shape<0> {  // m8n8k4
  static constexpr int M = 8, K = 4, A = 1, B = 1, D = 2;
};

__device__ __forceinline__ void mma(double (&d)[2], const double (&a)[1], const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[2], const double (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int S>
__global__ void throughput_kernel(int iters, double seed, double* out) {
  using Sh = Shape<S>;
  double a[Sh::A], b[Sh::B], d[kChains][Sh::D];
  // operands that depend on the thread, so that nothing folds away
#pragma unroll
  for (int i = 0; i < Sh::A; ++i) a[i] = seed * (static_cast<int>(threadIdx.x) + i + 1);
#pragma unroll
  for (int i = 0; i < Sh::B; ++i) b[i] = seed * (static_cast<int>(threadIdx.x) + 2 * i + 2);
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < Sh::D; ++e) d[c][e] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma(d[c], a, b);
  }
  double sum = 0.0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < Sh::D; ++e) sum += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int S>
__global__ void layout_kernel(const double* a_mk, const double* b_nk, double* d_mn) {
  using Sh = Shape<S>;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[Sh::A], b[Sh::B], d[Sh::D];
  if constexpr (S == 0) {
    a[0] = a_mk[g * Sh::K + t];
    b[0] = b_nk[g * Sh::K + t];
    d[0] = d[1] = 0.0;
    mma(d, a, b);
    d_mn[g * 8 + 2 * t] = d[0];
    d_mn[g * 8 + 2 * t + 1] = d[1];
  } else {
#pragma unroll
    for (int q = 0; q < Sh::K / 4; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) a[h + 2 * q] = a_mk[(g + 8 * h) * Sh::K + t + 4 * q];
      b[q] = b_nk[g * Sh::K + t + 4 * q];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = 0.0;
    mma(d, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) d_mn[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[e];
  }
}

template <int S>
int run_throughput(int blocks, int threads, int iters, double* out, cudaStream_t s) {
  throughput_kernel<S><<<blocks, threads, 0, s>>>(iters, 1e-3, out);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int run_layout(const double* a, const double* b, double* d, cudaStream_t s) {
  layout_kernel<S><<<1, 32, 0, s>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The flops a warp does in one launch of dmma_throughput: iters rounds of
// kChains mma of 2*M*8*K flops each.
double dmma_flops_per_warp(int shape, int iters) {
  const int m = shape == 0 ? 8 : 16, k = shape == 0 ? 4 : shape;
  return 2.0 * m * 8 * k * kChains * static_cast<double>(iters);
}

// Launch `blocks` blocks of `threads` threads (a multiple of 32) of the
// register-only loop of one shape (0: m8n8k4; 4, 8, 16: m16n8kK); out
// takes blocks * threads float64. Returns a cudaError_t.
int dmma_throughput(int shape, int blocks, int threads, int iters, void* out, void* stream) {
  double* o = static_cast<double*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return run_throughput<0>(blocks, threads, iters, o, s);
    case 4: return run_throughput<4>(blocks, threads, iters, o, s);
    case 8: return run_throughput<8>(blocks, threads, iters, o, s);
    case 16: return run_throughput<16>(blocks, threads, iters, o, s);
    default: return cudaErrorInvalidValue;
  }
}

// One mma of a shape with the fragments of the note: a [M, K], b [8, K]
// (B transposed) row-major float64 in, d [M, 8] out.
int dmma_layout(int shape, const void* a, const void* b, void* d, void* stream) {
  const double* pa = static_cast<const double*>(a);
  const double* pb = static_cast<const double*>(b);
  double* pd = static_cast<double*>(d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return run_layout<0>(pa, pb, pd, s);
    case 4: return run_layout<4>(pa, pb, pd, s);
    case 8: return run_layout<8>(pa, pb, pd, s);
    case 16: return run_layout<16>(pa, pb, pd, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* dmma_shapes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
