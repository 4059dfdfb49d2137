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
// closure_step: the saturating product of a 0/1 matrix with itself is a
// boolean product, C[i][j] = OR_k (R[i][k] AND R[k][j]).  As floats it is
// 2 n^3 operations; on this card the best rate for that work is the int8
// tensor-core peak (1979e12/s), against reading and writing 2 n^2 floats
// at 3.35 TB/s, so at the class hierarchy's size (n = 512) bytes bound it
// (0.63 us).  Design: two launches.  closure_step_pack_kernel reads R once and
// writes its bits twice, row-major and column-major (2 n^2 / 32 words,
// 64 KB at n = 512), with one warp ballot per 32 entries.
// closure_step_kernel gives each 32 x 32 output tile a block (256 blocks at
// n = 512), stages the tile's row and column words in shared memory and
// ORs n / 32 word ANDs per output, stopping at the first nonzero word:
// n^3 / 32 word operations, 32x fewer bytes through shared memory than
// floats.  Exact by construction (no sums); any nonzero entry counts as 1,
// which is min(R @ R, 1) on the TPU kernel's 0/1 contract.

// descendants: one matvec (2 n^2 operations, n^2 floats read), bound by
// reading the matrix.  The TPU carried the running count across its
// sequential grid; here one block of 32 warps walks the rows 32 at a
// time: warp w reduces row g + w against the root column with shuffles,
// warp 0 ballots the 32 flags and writes the set row ids at
// count + popc(ballot & lanemask_lt), so ids come out ascending.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCT = 32;          // output tile side of the product
constexpr int kCW = 32;          // words of k staged per pass

// R [n, n] -> its bits, twice: rows[i * nw + w] bit b = R[i][32 w + b] != 0,
// cols[j * nw + w] bit b = R[32 w + b][j] != 0 (nw = n / 32).  One block of
// 32 x 32 threads per 32 x 32 tile: a coalesced read, a ballot per row, the
// tile through shared memory, a ballot per column.
__global__ void __launch_bounds__(1024)
closure_step_pack_kernel(const float* __restrict__ A,
                         unsigned* __restrict__ rows,
                         unsigned* __restrict__ cols, int n) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int bi = blockIdx.y, bj = blockIdx.x, nw = n / 32;
  const float x = A[(size_t)(32 * bi + ty) * n + 32 * bj + tx];
  tile[ty][tx] = x;
  const unsigned rb = __ballot_sync(kFull, x != 0.f);
  if (tx == 0) rows[(size_t)(32 * bi + ty) * nw + bj] = rb;
  __syncthreads();
  const unsigned cb = __ballot_sync(kFull, tile[tx][ty] != 0.f);
  if (tx == 0) cols[(size_t)(32 * bj + ty) * nw + bi] = cb;
}

// C[i][j] = OR_w (rows[i][w] & cols[j][w]) != 0 as 1.0f / 0.0f.  One block
// of 256 threads per 32 x 32 output tile: the tile's row and column words
// staged kCW at a time, thread (ty, tx) owning column tx of rows ty + 8 r;
// an output stops at its first nonzero word.
__global__ void __launch_bounds__(256)
closure_step_kernel(const unsigned* __restrict__ rows,
                    const unsigned* __restrict__ cols, float* __restrict__ C,
                    int n) {
  __shared__ unsigned rs[kCT][kCW + 1];
  __shared__ unsigned cs[kCT][kCW + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int i0 = blockIdx.y * kCT, j0 = blockIdx.x * kCT, nw = n / 32;
  bool hit[4] = {false, false, false, false};
  for (int w0 = 0; w0 < nw; w0 += kCW) {
    const int ww = min(kCW, nw - w0);
    __syncthreads();
    for (int e = threadIdx.x; e < kCT * kCW; e += 256) {
      const int r = e / kCW, w = e % kCW;
      if (w < ww) {
        rs[r][w] = rows[(size_t)(i0 + r) * nw + w0 + w];
        cs[r][w] = cols[(size_t)(j0 + r) * nw + w0 + w];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (hit[i]) continue;
      const int r = ty + 8 * i;
      for (int w = 0; w < ww; ++w)
        if (rs[r][w] & cs[tx][w]) {
          hit[i] = true;
          break;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    C[(size_t)(i0 + ty + 8 * i) * n + j0 + tx] = hit[i] ? 1.f : 0.f;
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

// C = min(A @ A, 1) for a row-major [n, n] float32 A with entries in {0, 1}
// (any nonzero counts as 1), n a multiple of 64; bits is 2 n^2 / 32 words of
// scratch.
int closure_step_launch(const void* A, void* bits, void* C, int n,
                        void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* rows = (unsigned*)bits;
  unsigned* cols = rows + (size_t)n * (n / 32);
  const dim3 grid(n / 32, n / 32);
  closure_step_pack_kernel<<<grid, 1024, 0, s>>>((const float*)A, rows, cols,
                                                 n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  closure_step_kernel<<<grid, 256, 0, s>>>(rows, cols, (float*)C, n);
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
