// Transitive-closure kernels for Hopper (sm_90a): the saturating boolean
// matrix product and the fused descendants step.
//
// Replaces the TPU kernels
//   src/repro/kernels/closure/kernel.py  closure_step_pallas
//     (_bool_matmul_kernel: min(R @ R, 1), 128^3 tiles, f32 accumulator)
//   src/repro/kernels/closure/kernel.py  descendants_pallas
//     (_descendants_kernel: min(reach @ reach[:, root], 1) > 0.5, with the
//      set row ids compacted in ascending order and a count)
//
// closure_step: 2 n^3 float32 operations on n^2 floats, so at the class
// hierarchy's size (n = 512) it is bound by operations (a few tens of
// MFLOP), far below any memory limit.  Design: a shared-memory tiled
// product, 64 x 64 output tiles, K-depth 16, 256 threads each holding a
// 4 x 4 accumulator block, min(acc, 1) in the epilogue.  Exact: entries
// are 0/1 and every sum is at most n < 2^24.  wgmma/TMA are later work.
//
// descendants: one matvec (2 n^2 operations, n^2 floats read), bound by
// reading the matrix.  The TPU carried the running count across its
// sequential grid; here one block of 32 warps walks the rows 32 at a
// time: warp w reduces row g + w against the root column with shuffles,
// warp 0 ballots the 32 flags and writes the set row ids at
// count + popc(ballot & lanemask_lt), so ids come out ascending.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(256)
bool_matmul_kernel(const float* __restrict__ A, float* __restrict__ C, int n) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += 256) {
      const int r = i / kBK, c = i % kBK;
      As[c][r] = A[(size_t)(row0 + r) * n + k0 + c];
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += 256) {
      const int r = i / kBN, c = i % kBN;
      Bs[r][c] = A[(size_t)(k0 + r) * n + col0 + c];
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      C[(size_t)(row0 + ty * 4 + i) * n + col0 + tx * 4 + j] =
          fminf(acc[i][j], 1.f);
}

__global__ void __launch_bounds__(1024)
descendants_kernel(const float* __restrict__ reach,
                   const float* __restrict__ rootcol, int n,
                   int* __restrict__ ids, int* __restrict__ count,
                   int out_cap) {
  __shared__ int flags[32];
  __shared__ int running;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  for (int g = 0; g < n; g += 32) {
    const int row = g + warp;
    float s = 0.f;
    if (row < n)
      for (int k = lane; k < n; k += 32)
        s += reach[(size_t)row * n + k] * rootcol[k];
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) flags[warp] = (row < n) && (fminf(s, 1.f) > 0.5f);
    __syncthreads();
    if (warp == 0) {
      const int f = flags[lane];
      const unsigned bal = __ballot_sync(kFull, f);
      const int base = running;
      if (f) {
        const int pos = base + __popc(bal & ((1u << lane) - 1u));
        if (pos < out_cap) ids[pos] = g + lane;
      }
      __syncwarp();
      if (lane == 0) running = base + __popc(bal);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = running;
}

}  // namespace

extern "C" {

// C = min(A @ A, 1) for a row-major [n, n] float32 A, n a multiple of 64.
int closure_step_launch(const void* A, void* C, int n, void* stream) {
  if (n == 0) return 0;
  const dim3 grid(n / kBN, n / kBM);
  bool_matmul_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)C, n);
  return (int)cudaGetLastError();
}

// ids[:min(count, out_cap)] = ascending i with min(reach @ rootcol, 1)[i] > .5
int descendants_launch(const void* reach, const void* rootcol, int n,
                       void* ids, void* count, int out_cap, void* stream) {
  descendants_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const float*)reach, (const float*)rootcol, n, (int*)ids, (int*)count,
      out_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
