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
// reading the matrix.  On the 0/1 contract, min(reach @ rootcol, 1)[i] >
// 0.5 holds exactly when some k has reach[i][k] != 0 and rootcol[k] != 0
// (the sum of 0/1 products is at least 1), so the kernel tests for any
// such k and sums nothing.  The TPU carried the running count across its
// sequential grid; here one launch of a cluster of C <= 8 blocks, each
// owning a contiguous share of the rows in whole 32-row words:
//   * every block stages the root column (read with its stride, so the
//     caller passes a column view) as an n/32-word bit mask in shared
//     memory, one ballot per 32 entries;
//   * each warp takes 4 rows at a time, its lanes reading 16-byte chunks
//     of them (the four rows' loads issued together) where the chunk's 4
//     root bits are not all zero (a sparse root column skips most of the
//     matrix), and keeps one flag a row (__any_sync); the block then
//     ballots its rows' flags into words;
//   * each block pushes its popcount total into the others' shared memory
//     (distributed shared memory; a split barrier begun at the start has
//     shown that they all run); after one cluster barrier each sums the
//     earlier blocks' totals from its own, writes its ids in ascending
//     order at that offset (while below out_cap) and its stripe of the zero
//     tail, and block 0 writes count.
// No fill, no atomic and no scratch: the wrapper allocates with
// torch.empty.

#include <cooperative_groups.h>
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

constexpr int kDTThreads = 512;
constexpr int kDTWarps = kDTThreads / 32;
constexpr int kDTRows = 4;        // rows a warp reads at once
constexpr int kDTMaxCluster = 8;  // the portable cluster size

// grid (C), cluster (C, 1, 1); block c owns the row words [c WB, (c + 1)
// WB) of the nw = ceil(n / 32), WB = ceil(nw / C).  kVec: n % 4 == 0 and
// reach 16-byte aligned, so rows are read as float4.
template <bool kVec>
__global__ void __launch_bounds__(kDTThreads)
descendants_kernel(const float* __restrict__ reach,
                   const float* __restrict__ rootcol, long long stride, int n,
                   int* __restrict__ ids, int* __restrict__ count,
                   int out_cap) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = (n + 31) >> 5, wb = (nw + C - 1) / C;
  const int w0 = min(nw, c * wb), nb = min(nw, w0 + wb) - w0;
  const int row0 = 32 * w0, row1 = min(n, 32 * (w0 + nb));
  extern __shared__ __align__(16) unsigned dt_smem[];
  unsigned* s_root = dt_smem;             // [nw] root-column bits
  unsigned* s_word = s_root + nw;         // [wb] the block's row flags
  int* s_pre = reinterpret_cast<int*>(s_word + wb);  // [wb] popc prefix
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_pre + wb);  // [32 wb]
  __shared__ int s_counts[kDTMaxCluster];   // every block's, pushed by them

  // every block has started once this phase completes: the counts pushed
  // into the others' shared memory below find it there
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  for (int i = warp; i < nw; i += kDTWarps) {
    const int k = 32 * i + lane;
    const unsigned b =
        __ballot_sync(kFull, k < n && rootcol[k * stride] != 0.f);
    if (lane == 0) s_root[i] = b;
  }
  __syncthreads();

  for (int g = row0 + warp * kDTRows; g < row1; g += kDTWarps * kDTRows) {
    bool hit[kDTRows];
#pragma unroll
    for (int j = 0; j < kDTRows; ++j) hit[j] = false;
    if (kVec) {
      const int n4 = n >> 2;
      for (int k4 = lane; k4 < n4; k4 += 32) {
        const unsigned rb = (s_root[k4 >> 3] >> (4 * (k4 & 7))) & 0xFu;
        if (!rb) continue;
        float4 x[kDTRows];              // the rows' loads issued together
#pragma unroll
        for (int j = 0; j < kDTRows; ++j)
          x[j] = __ldg(reinterpret_cast<const float4*>(
                           reach + (size_t)min(g + j, row1 - 1) * n) + k4);
#pragma unroll
        for (int j = 0; j < kDTRows; ++j) {
          const unsigned nz = (x[j].x != 0.f) | (x[j].y != 0.f) << 1 |
                              (x[j].z != 0.f) << 2 | (x[j].w != 0.f) << 3;
          hit[j] |= (nz & rb) != 0u;
        }
      }
    } else {
      for (int k = lane; k < n; k += 32) {
        if (!(s_root[k >> 5] >> (k & 31) & 1u)) continue;
        float x[kDTRows];
#pragma unroll
        for (int j = 0; j < kDTRows; ++j)
          x[j] = reach[(size_t)min(g + j, row1 - 1) * n + k];
#pragma unroll
        for (int j = 0; j < kDTRows; ++j) hit[j] |= x[j] != 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kDTRows; ++j) {
      const bool f = __any_sync(kFull, hit[j]);
      if (lane == 0 && g + j < row1) s_flag[g + j - row0] = f;
    }
  }
  __syncthreads();
  for (int i = warp; i < nb; i += kDTWarps) {
    const int r = 32 * i + lane;
    const unsigned b = __ballot_sync(kFull, row0 + r < row1 && s_flag[r]);
    if (lane == 0) s_word[i] = b;
  }
  __syncthreads();
  int flagged = 0;                      // the block's rows with the flag
  if (warp == 0) {                      // exclusive prefix of the popcounts
    for (int i0 = 0; i0 < nb; i0 += 32) {
      const int i = i0 + lane;
      const int p = i < nb ? __popc(s_word[i]) : 0;
      int x = p;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (i < nb) s_pre[i] = flagged + x - p;
      flagged += __shfl_sync(kFull, x, 31);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0 && lane < C)            // push the count to block lane
    *cluster.map_shared_rank(&s_counts[c], lane) = flagged;
  cluster.sync();                       // the pushes have landed; no remote
  int base = 0, total = 0;              // access follows
  for (int r = 0; r < C; ++r) {
    total += s_counts[r];
    base += r < c ? s_counts[r] : 0;
  }
  for (int i = warp; i < nb; i += kDTWarps) {
    const unsigned b = s_word[i];
    if (b >> lane & 1u) {
      const int pos = base + s_pre[i] + __popc(b & ((1u << lane) - 1u));
      if (pos < out_cap) ids[pos] = 32 * (w0 + i) + lane;
    }
  }
  for (int k = min(total, out_cap) + c * kDTThreads + tid; k < out_cap;
       k += C * kDTThreads)
    ids[k] = 0;
  if (c == 0 && tid == 0) *count = total;
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

// ids[:min(count, out_cap)] = ascending i with min(reach @ rootcol, 1)[i] >
// .5, then zeros, and count, for a row-major [n, n] reach with entries in
// {0, 1} and rootcol[k] at rootcol + k * stride: one launch of a cluster of
// up to kDTMaxCluster blocks, writing ids and count whole.
int descendants_launch(const void* reach, const void* rootcol,
                       long long stride, int n, void* ids, void* count,
                       int out_cap, void* stream) {
  const int nw = (n + 31) / 32;
  const int C = max(1, min(kDTMaxCluster, nw));
  const int wb = (nw + C - 1) / C;
  const size_t bytes = (size_t)nw * 4 + (size_t)wb * (4 + 4 + 32);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kDTThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = n % 4 == 0 && ((uintptr_t)reach & 15u) == 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, vec ? descendants_kernel<true> : descendants_kernel<false>,
      (const float*)reach, (const float*)rootcol, stride, n, (int*)ids,
      (int*)count, out_cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
