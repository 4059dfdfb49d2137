// Window-vs-KB joins for Hopper (sm_90a): the fused scan join and the fused
// probe join, each as count -> exclusive scan -> scatter, and the unfused
// scan join's candidate matrix.
//
// Replaces the TPU kernels
//   src/repro/kernels/hash_join/kernel.py  join_compact_pallas
//     (_count_kernel, _scatter_kernel, _tile_match, _extend_tile)
//   src/repro/kernels/hash_join/kernel.py  probe_compact_pallas
//     (_probe_kernel, _probe_match, _probe_extend)
//   src/repro/kernels/hash_join/kernel.py  match_matrix_pallas
//     (_match_kernel)
//
// The TPU grid runs in order and carries running bases across grid steps
// (counts_ref / rowbase_ref / base_ref).  CUDA blocks run in parallel, so
// the carry becomes: a count pass writing per-binding-row match counts, an
// exclusive cumsum of the [W, M] counts in PyTorch, and a scatter pass that
// re-derives every match and writes it to offset[row] + rank.  The result
// is the global row-major order of the virtual candidate matrix, bit for
// bit what compacting the materialised matrix gives.
//
// Scan join.  What bounds it on this card: every live binding row compares
// against every KB row, so the work is (live rows x KB rows) 32-bit
// compares; the KB itself (13 bytes a row) is re-read from L2 by every
// block.  Design: one warp per binding row, 32 KB rows per step tested
// with __ballot_sync, __popc for counts and for the in-row rank
// (popc(ballot & lanemask_lt)); the block stages KB tiles in shared memory
// so its 16 warps share each tile.  A block whose binding rows are all
// invalid exits before touching the KB (bindings are compacted, so live
// rows sit at the front).
//
// Probe join.  Bounded by the binary searches' dependent loads (log2 N per
// live row) and the k_max gathers: a few KB of traffic per chunk.  One
// thread per binding row; the count pass stores [lo, hi) for the scatter
// pass, which re-checks the candidates and writes matches in candidate
// order.
//
// Match matrix.  Writes the int8 [W, M, N] all-slot equality of every
// binding row against every KB row (1 = match), which the caller compacts.
// Bounded by its int8 writes: W*M*N bytes out against 13 bytes a KB row and
// 4*nv bytes a binding row in.  Design: each thread owns a run of 16
// consecutive KB columns and keeps their words in registers (loaded once)
// for the block's 64 binding rows, whose bound values and validity the
// block stages in shared memory; per row it writes its 16 results as one
// 16-byte store where the row's alignment allows, so a warp stores 512
// contiguous bytes.  The CONST slots and repeated-variable agreement
// depend on the KB row alone and are folded once per column into a bit
// mask; a dead row, or a run no KB row of which can match, costs one
// store of zeros.  Output offsets are 64-bit: M*N alone
// passes 2^31 at the main path's shapes.
//
// Ids are uint32 words.  The pattern is passed as small int arguments
// (slot modes, constants, variable columns, repeated-variable flags): one
// compiled kernel serves every pattern.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 16;      // warps (= binding rows) per block
constexpr int kTile = 2048;            // KB rows staged in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNumBase = 1u << 30;
constexpr int kTermBits = 20;
constexpr uint32_t kTermMask = (1u << kTermBits) - 1u;
constexpr uint32_t kPredSpace = 1u << 12;

struct Pattern {
  int mode[3];        // 0 CONST, 1 BOUND, 2 FREE
  uint32_t cst[3];    // constant of a CONST slot
  int var[3];         // binding column of a BOUND/FREE slot
  int eq01, eq02, eq12;   // repeated variable: the two slots must agree
};

__device__ __forceinline__ bool slot_ok(int mode, uint32_t kv, uint32_t cst,
                                        uint32_t bv) {
  return mode == 0 ? kv == cst : (mode == 1 ? kv == bv : true);
}

__device__ __forceinline__ void write_row(uint32_t* orow, const uint32_t* crow,
                                          int nv, const Pattern& pat,
                                          uint32_t a, uint32_t b, uint32_t c) {
  for (int k = 0; k < nv; ++k) orow[k] = crow[k];
  if (pat.mode[0] == 2) orow[pat.var[0]] = a;
  if (pat.mode[1] == 2) orow[pat.var[1]] = b;
  if (pat.mode[2] == 2) orow[pat.var[2]] = c;
}

template <bool kScatter>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
scan_join_kernel(const uint32_t* __restrict__ cols,
                 const uint8_t* __restrict__ bvalid, int M, int nv,
                 const uint32_t* __restrict__ ks,
                 const uint32_t* __restrict__ kp,
                 const uint32_t* __restrict__ ko,
                 const uint8_t* __restrict__ kvalid, int N, Pattern pat,
                 int* __restrict__ counts,
                 const long long* __restrict__ offsets,
                 uint32_t* __restrict__ out, int out_cap) {
  __shared__ uint32_t t_s[kTile], t_p[kTile], t_o[kTile];
  __shared__ uint8_t t_v[kTile];
  const int w = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  const size_t r = (size_t)w * M + row;
  const bool live = row < M && bvalid[r];
  if (!__syncthreads_or(live)) return;          // every row of the block idle

  const uint32_t* crow = cols + r * nv;
  uint32_t bv[3];
  for (int i = 0; i < 3; ++i)
    bv[i] = (live && pat.mode[i] == 1) ? crow[pat.var[i]] : 0u;
  const long long off = (kScatter && live) ? offsets[r] : 0;
  long long base = 0;
  int count = 0;
  bool done = !live;
  const unsigned lt = (1u << lane) - 1u;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      t_s[i] = ks[t0 + i];
      t_p[i] = kp[t0 + i];
      t_o[i] = ko[t0 + i];
      t_v[i] = kvalid[t0 + i];
    }
    __syncthreads();
    if (done) continue;                           // warp-uniform
    for (int j0 = 0; j0 < tn; j0 += 32) {
      const int j = j0 + lane;
      bool m = false;
      uint32_t a = 0, b = 0, c = 0;
      if (j < tn) {
        a = t_s[j];
        b = t_p[j];
        c = t_o[j];
        m = t_v[j] && slot_ok(pat.mode[0], a, pat.cst[0], bv[0]) &&
            slot_ok(pat.mode[1], b, pat.cst[1], bv[1]) &&
            slot_ok(pat.mode[2], c, pat.cst[2], bv[2]) &&
            (!pat.eq01 || a == b) && (!pat.eq02 || a == c) &&
            (!pat.eq12 || b == c);
      }
      const unsigned bal = __ballot_sync(kFull, m);
      if (kScatter) {
        if (m) {
          const long long pos = off + base + __popc(bal & lt);
          if (pos < out_cap)
            write_row(out + ((size_t)w * out_cap + pos) * nv, crow, nv, pat,
                      a, b, c);
        }
        base += __popc(bal);
      } else {
        count += __popc(bal);
      }
    }
    if (kScatter && off + base >= out_cap) done = true;
  }
  if (!kScatter && live && lane == 0) counts[r] = count;
}

__device__ __forceinline__ uint32_t composite_key(uint32_t p, uint32_t t) {
  uint32_t low = t >= kNumBase ? ((t ^ (t >> kTermBits)) & kTermMask)
                               : ((t - kPredSpace) & kTermMask);
  if (t == 0u) low = 0u;
  return (p << kTermBits) | low;
}

__device__ __forceinline__ int lower_bound(const uint32_t* keys, int n,
                                           uint32_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const uint32_t* keys, int n,
                                           uint32_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kScatter>
__global__ void probe_join_kernel(const uint32_t* __restrict__ cols,
                                  const uint8_t* __restrict__ bvalid, int M,
                                  int nv, const uint32_t* __restrict__ vs,
                                  const uint32_t* __restrict__ vp,
                                  const uint32_t* __restrict__ vo,
                                  const uint32_t* __restrict__ keys, int N,
                                  Pattern pat, int anchor, uint32_t p_const,
                                  int k_max, int* __restrict__ counts,
                                  int* __restrict__ fan,
                                  int* __restrict__ range,
                                  const long long* __restrict__ offsets,
                                  uint32_t* __restrict__ out, int out_cap) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (row >= M) return;
  const size_t r = (size_t)w * M + row;
  const uint32_t* crow = cols + r * nv;
  const bool live = bvalid[r];
  int lo, hi;
  if (!kScatter) {
    const uint32_t a = pat.mode[anchor] == 0 ? pat.cst[anchor]
                                             : crow[pat.var[anchor]];
    const uint32_t q = composite_key(p_const, a);
    lo = lower_bound(keys, N, q);
    hi = upper_bound(keys, N, q);
    fan[r] = (hi - lo) > k_max ? 1 : 0;
    range[2 * r] = lo;
    range[2 * r + 1] = hi;
    if (!live) return;                 // counts were zeroed by the wrapper
  } else {
    if (!live) return;
    lo = range[2 * r];
    hi = range[2 * r + 1];
  }
  uint32_t bv[3];
  for (int i = 0; i < 3; ++i) bv[i] = pat.mode[i] == 1 ? crow[pat.var[i]] : 0u;
  long long pos = kScatter ? offsets[r] : 0;
  int cnt = 0;
  const int end = min(hi, lo + k_max);
  for (int idx = lo; idx < end; ++idx) {
    const uint32_t a = vs[idx], b = vp[idx], c = vo[idx];
    const bool m = slot_ok(pat.mode[0], a, pat.cst[0], bv[0]) &&
                   slot_ok(pat.mode[1], b, pat.cst[1], bv[1]) &&
                   slot_ok(pat.mode[2], c, pat.cst[2], bv[2]);
    if (!m) continue;
    if (kScatter) {
      if (pos >= out_cap) break;
      write_row(out + ((size_t)w * out_cap + pos) * nv, crow, nv, pat, a, b, c);
      ++pos;
    } else {
      ++cnt;
    }
  }
  if (!kScatter) counts[r] = cnt;
}

constexpr int kMMThreads = 256;
constexpr int kMMCols = 16;                     // KB columns per thread
constexpr int kMMTile = kMMThreads * kMMCols;   // KB columns per block
constexpr int kMMRows = 64;                     // binding rows per block

// One thread's 16 results of one row (4 words of 4 bytes) to ``dst``: one
// 16-byte store where the address allows it, else 8-, 4- or 1-byte ones
// (a row starts at w*M*N + r*N, aligned only as far as N is).
__device__ __forceinline__ void store_run(uint8_t* dst, const uint32_t* word,
                                          int nc) {
  const uintptr_t addr = (uintptr_t)dst;
  if (nc == kMMCols && (addr & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(word[0], word[1], word[2], word[3]);
  } else if (nc == kMMCols && (addr & 7u) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(word[0], word[1]);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(word[2], word[3]);
  } else if (nc == kMMCols && (addr & 3u) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) reinterpret_cast<uint32_t*>(dst)[q] = word[q];
  } else {
    for (int k = 0; k < nc; ++k)
      dst[k] = (uint8_t)(word[k >> 2] >> (8 * (k & 3)));
  }
}

__global__ void __launch_bounds__(kMMThreads)
match_matrix_kernel(const uint32_t* __restrict__ cols,
                    const uint8_t* __restrict__ bvalid, int M, int nv,
                    const uint32_t* __restrict__ ks,
                    const uint32_t* __restrict__ kp,
                    const uint32_t* __restrict__ ko,
                    const uint8_t* __restrict__ kvalid, int N, Pattern pat,
                    uint8_t* __restrict__ out) {
  __shared__ uint32_t r_bv[3][kMMRows];
  __shared__ uint8_t r_live[kMMRows];
  const int w = blockIdx.z;
  const int r0 = blockIdx.y * kMMRows;
  const int rows = min(kMMRows, M - r0);
  for (int i = threadIdx.x; i < kMMRows; i += blockDim.x) {
    const long long r = (long long)w * M + r0 + i;
    const bool live = i < rows && bvalid[r];
    r_live[i] = live;
    for (int k = 0; k < 3; ++k)
      r_bv[k][i] = (live && pat.mode[k] == 1)
                       ? cols[r * nv + pat.var[k]] : 0u;
  }
  __syncthreads();

  const int c0 = blockIdx.x * kMMTile + threadIdx.x * kMMCols;
  if (c0 >= N) return;
  const int nc = min(kMMCols, N - c0);
  uint32_t a[kMMCols], b[kMMCols], c[kMMCols];
  unsigned ok = 0u;                         // bit k: column k passes the
#pragma unroll                              // KB-only conditions
  for (int k = 0; k < kMMCols; ++k) {
    const int j = c0 + min(k, nc - 1);
    a[k] = ks[j];
    b[k] = kp[j];
    c[k] = ko[j];
    const bool m = k < nc && kvalid[j] &&
                   (pat.mode[0] != 0 || a[k] == pat.cst[0]) &&
                   (pat.mode[1] != 0 || b[k] == pat.cst[1]) &&
                   (pat.mode[2] != 0 || c[k] == pat.cst[2]) &&
                   (!pat.eq01 || a[k] == b[k]) &&
                   (!pat.eq02 || a[k] == c[k]) &&
                   (!pat.eq12 || b[k] == c[k]);
    ok |= (unsigned)m << k;
  }
  for (int i = 0; i < rows; ++i) {
    uint32_t word[4] = {0u, 0u, 0u, 0u};
    if (r_live[i] && ok) {
      const uint32_t b0 = r_bv[0][i], b1 = r_bv[1][i], b2 = r_bv[2][i];
#pragma unroll
      for (int k = 0; k < kMMCols; ++k) {
        const bool m = ((ok >> k) & 1u) &&
                       (pat.mode[0] != 1 || a[k] == b0) &&
                       (pat.mode[1] != 1 || b[k] == b1) &&
                       (pat.mode[2] != 1 || c[k] == b2);
        word[k >> 2] |= (uint32_t)m << (8 * (k & 3));
      }
    }
    store_run(out + ((long long)w * M + r0 + i) * (long long)N + c0, word,
              nc);
  }
}

Pattern make_pattern(int s_mode, unsigned s_cst, int s_var, int p_mode,
                     unsigned p_cst, int p_var, int o_mode, unsigned o_cst,
                     int o_var, int eq01, int eq02, int eq12) {
  Pattern pat;
  pat.mode[0] = s_mode; pat.cst[0] = s_cst; pat.var[0] = s_var;
  pat.mode[1] = p_mode; pat.cst[1] = p_cst; pat.var[1] = p_var;
  pat.mode[2] = o_mode; pat.cst[2] = o_cst; pat.var[2] = o_var;
  pat.eq01 = eq01; pat.eq02 = eq02; pat.eq12 = eq12;
  return pat;
}

}  // namespace

extern "C" {

// phase: 0 = count (writes counts), 1 = scatter (reads offsets, writes out)
int scan_join_launch(int phase, const void* cols, const void* bvalid, int W,
                     int M, int nv, const void* ks, const void* kp,
                     const void* ko, const void* kvalid, int N, int s_mode,
                     unsigned s_cst, int s_var, int p_mode, unsigned p_cst,
                     int p_var, int o_mode, unsigned o_cst, int o_var,
                     int eq01, int eq02, int eq12, void* counts,
                     const void* offsets, void* out, int out_cap,
                     void* stream) {
  if (W == 0 || M == 0) return 0;
  const Pattern pat = make_pattern(s_mode, s_cst, s_var, p_mode, p_cst, p_var,
                                   o_mode, o_cst, o_var, eq01, eq02, eq12);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, W);
  const dim3 block(kRowsPerBlock * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (phase == 0) {
    scan_join_kernel<false><<<grid, block, 0, st>>>(
        (const uint32_t*)cols, (const uint8_t*)bvalid, M, nv,
        (const uint32_t*)ks, (const uint32_t*)kp, (const uint32_t*)ko,
        (const uint8_t*)kvalid, N, pat, (int*)counts, nullptr, nullptr,
        out_cap);
  } else {
    scan_join_kernel<true><<<grid, block, 0, st>>>(
        (const uint32_t*)cols, (const uint8_t*)bvalid, M, nv,
        (const uint32_t*)ks, (const uint32_t*)kp, (const uint32_t*)ko,
        (const uint8_t*)kvalid, N, pat, nullptr, (const long long*)offsets,
        (uint32_t*)out, out_cap);
  }
  return (int)cudaGetLastError();
}

int probe_join_launch(int phase, const void* cols, const void* bvalid, int W,
                      int M, int nv, const void* vs, const void* vp,
                      const void* vo, const void* keys, int N, int s_mode,
                      unsigned s_cst, int s_var, int p_mode, unsigned p_cst,
                      int p_var, int o_mode, unsigned o_cst, int o_var,
                      int anchor, int k_max, void* counts, void* fan,
                      void* range, const void* offsets, void* out,
                      int out_cap, void* stream) {
  if (W == 0 || M == 0) return 0;
  const Pattern pat = make_pattern(s_mode, s_cst, s_var, p_mode, p_cst, p_var,
                                   o_mode, o_cst, o_var, 0, 0, 0);
  const dim3 block(128);
  const dim3 grid((M + 127) / 128, W);
  cudaStream_t st = (cudaStream_t)stream;
  if (phase == 0) {
    probe_join_kernel<false><<<grid, block, 0, st>>>(
        (const uint32_t*)cols, (const uint8_t*)bvalid, M, nv,
        (const uint32_t*)vs, (const uint32_t*)vp, (const uint32_t*)vo,
        (const uint32_t*)keys, N, pat, anchor, p_cst, k_max, (int*)counts,
        (int*)fan, (int*)range, nullptr, nullptr, out_cap);
  } else {
    probe_join_kernel<true><<<grid, block, 0, st>>>(
        (const uint32_t*)cols, (const uint8_t*)bvalid, M, nv,
        (const uint32_t*)vs, (const uint32_t*)vp, (const uint32_t*)vo,
        (const uint32_t*)keys, N, pat, anchor, p_cst, k_max, nullptr, nullptr,
        (int*)range, (const long long*)offsets, (uint32_t*)out, out_cap);
  }
  return (int)cudaGetLastError();
}

int match_matrix_launch(const void* cols, const void* bvalid, int W, int M,
                        int nv, const void* ks, const void* kp, const void* ko,
                        const void* kvalid, int N, int s_mode, unsigned s_cst,
                        int s_var, int p_mode, unsigned p_cst, int p_var,
                        int o_mode, unsigned o_cst, int o_var, int eq01,
                        int eq02, int eq12, void* out, void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  const Pattern pat = make_pattern(s_mode, s_cst, s_var, p_mode, p_cst, p_var,
                                   o_mode, o_cst, o_var, eq01, eq02, eq12);
  const dim3 grid((N + kMMTile - 1) / kMMTile, (M + kMMRows - 1) / kMMRows, W);
  match_matrix_kernel<<<grid, kMMThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, (const uint8_t*)bvalid, M, nv,
      (const uint32_t*)ks, (const uint32_t*)kp, (const uint32_t*)ko,
      (const uint8_t*)kvalid, N, pat, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
