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
// the carry becomes a count pass, an exclusive scan, and a scatter pass
// that re-derives every match and writes it at its offset.  The result is
// the global row-major order of the virtual candidate matrix, bit for bit
// what compacting the materialised matrix gives.
//
// Scan join.  The work a scan must do: read the KB once (13 bytes a row),
// test the conditions that depend on the KB row alone (validity, CONST
// slots, a repeated variable) once per KB row, and compare the BOUND slots
// of every live binding row with every KB row that passes them.  That is
// 32-bit integer equality: no MMA form computes it, so the tensor cores
// have no part here and the bound is the INT32 lanes' rate.  Design:
//   * a block owns a tile of 4096 consecutive KB rows of the (p, s) view:
//     each of its 256 threads loads a run of 16 rows into registers once
//     (16-byte loads) and folds the KB-only conditions into a 16-bit mask;
//     a thread whose mask is zero does no per-row work, and a block whose
//     threads all have zero masks only writes zero counts;
//   * the block also owns a group of 1024 binding rows (the windows'
//     [W, M] rows flattened).  It stages the group's live rows, compacted,
//     with their BOUND words in shared memory; a group with no live row
//     exits after reading its validity, whatever the rows' order.  Each
//     live row's words are broadcast to every thread, which tests its 16
//     register rows with one chained compare a pair and a BOUND slot; a
//     warp none of whose rows can match moves on (matches are rare on the
//     path), else it builds the match mask, masks it, and sums the popcs
//     (one warp reduction, one shared atomic).  Every KB row is read once
//     per live row group (8 times a call at the main path's shape), never
//     skipped by sort order;
//   * count -> scan -> scatter over (row, tile).  The count pass writes one
//     partial count per (tile, row) of a live group, [tiles, W*M] int32 (a
//     block writes its 1024 entries contiguously; entries of groups with no
//     live row are never read, so the tensor is not zero-filled), and adds
//     it to the row's total (an int32 atomic).  The wrapper scans the
//     [W, M] totals (torch.cumsum, int64: a window's total may pass 2^31).
//     The scatter pass revisits only the rows whose partial count in its
//     tile is non-zero and whose offset is below out_cap.  A row's offset
//     in the tile is its window offset plus its partial counts of the
//     tiles before (summed by the block, one entry a thread), plus a
//     block-wide exclusive prefix of the threads' popcounts: thread order
//     is KB order.  Matches are written while below out_cap.
//   * the BOUND slots are a template parameter (8 instantiations a pass),
//     so the inner loop holds only the compares it needs.
// A row group is staged once per block (12 KB of words at most), so there
// is no stream of binding rows to double-buffer.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNumBase = 1u << 30;
constexpr int kTermBits = 20;
constexpr uint32_t kTermMask = (1u << kTermBits) - 1u;
constexpr uint32_t kPredSpace = 1u << 12;

constexpr int kSJThreads = 256;
constexpr int kSJWarps = kSJThreads / 32;
constexpr int kSJRun = 16;                          // KB rows per thread
constexpr int kSJTile = kSJThreads * kSJRun;        // KB rows per block
constexpr int kSJGroup = 1024;                      // binding rows per block
constexpr int kSJRowsPerThread = kSJGroup / kSJThreads;

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

// Exclusive prefix over the block of one int a thread (thread order), and
// the block's total.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kSJWarps; ++i) {
    const int t = s_warp[i];
    base += i < warp ? t : 0;
    tot += t;
  }
  *total = tot;
  __syncthreads();                              // s_warp free again
  return base + x - v;
}

// The block's run of KB rows in registers: thread j holds rows
// tile0 + 16 j .. + 15 (clamped at N; rows past N fail the mask), and the
// mask of those that pass the KB-only conditions.
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p,
                                           int j0, int nc, uint32_t (&x)[kSJRun]) {
  if (nc == kSJRun && (reinterpret_cast<uintptr_t>(p + j0) & 15u) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p + j0);
#pragma unroll
    for (int i = 0; i < kSJRun / 4; ++i) {
      const uint4 v = __ldg(q + i);
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z; x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSJRun; ++k) x[k] = p[j0 + min(k, nc - 1)];
  }
}

__device__ __forceinline__ unsigned load_run(
    const uint32_t* __restrict__ ks, const uint32_t* __restrict__ kp,
    const uint32_t* __restrict__ ko, const uint8_t* __restrict__ kvalid,
    int N, const Pattern& pat, uint32_t (&a)[kSJRun], uint32_t (&b)[kSJRun],
    uint32_t (&c)[kSJRun]) {
  const long long c0 = (long long)blockIdx.x * kSJTile + threadIdx.x * kSJRun;
  if (c0 >= N) {
#pragma unroll
    for (int k = 0; k < kSJRun; ++k) a[k] = b[k] = c[k] = 0u;
    return 0u;
  }
  const int j0 = (int)c0;
  const int nc = min(kSJRun, N - j0);
  load_words(ks, j0, nc, a);
  load_words(kp, j0, nc, b);
  load_words(ko, j0, nc, c);
  uint8_t v[kSJRun];
  if (nc == kSJRun && (reinterpret_cast<uintptr_t>(kvalid + j0) & 15u) == 0) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(kvalid + j0));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < kSJRun; ++k) v[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
  } else {
#pragma unroll
    for (int k = 0; k < kSJRun; ++k) v[k] = k < nc ? kvalid[j0 + k] : 0;
  }
  unsigned ok = 0u;
#pragma unroll
  for (int k = 0; k < kSJRun; ++k) {
    const bool m = v[k] &&
                   (pat.mode[0] != 0 || a[k] == pat.cst[0]) &&
                   (pat.mode[1] != 0 || b[k] == pat.cst[1]) &&
                   (pat.mode[2] != 0 || c[k] == pat.cst[2]) &&
                   (!pat.eq01 || a[k] == b[k]) &&
                   (!pat.eq02 || a[k] == c[k]) &&
                   (!pat.eq12 || b[k] == c[k]);
    ok |= (unsigned)m << k;
  }
  return ok;
}

// Bit k: register row k equals the binding row in every BOUND slot
// (kBound: bit i set when slot i is BOUND).
template <int kBound>
__device__ __forceinline__ unsigned bound_bits(const uint32_t (&a)[kSJRun],
                                               const uint32_t (&b)[kSJRun],
                                               const uint32_t (&c)[kSJRun],
                                               uint32_t b0, uint32_t b1,
                                               uint32_t b2) {
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < kSJRun; ++k) {
    bool m = true;
    if (kBound & 1) m = m && a[k] == b0;
    if (kBound & 2) m = m && b[k] == b1;
    if (kBound & 4) m = m && c[k] == b2;
    bits |= (unsigned)m << k;
  }
  return bits;
}

// Whether any register row equals the binding row in every BOUND slot,
// validity and the KB-only mask aside: one predicated compare a pair and a
// BOUND slot, chained (the count pass's filter; matches are rare there).
template <int kBound>
__device__ __forceinline__ bool any_bound(const uint32_t (&a)[kSJRun],
                                          const uint32_t (&b)[kSJRun],
                                          const uint32_t (&c)[kSJRun],
                                          uint32_t b0, uint32_t b1,
                                          uint32_t b2) {
  if (kBound == 0) return true;
  bool any = false;
#pragma unroll
  for (int k = 0; k < kSJRun; ++k) {
    bool m = true;
    if (kBound & 1) m = m && a[k] == b0;
    if (kBound & 2) m = m && b[k] == b1;
    if (kBound & 4) m = m && c[k] == b2;
    any = any || m;
  }
  return any;
}

// Stage the block's row group: the rows that pass ``keep`` (live rows, in
// row order) into s_idx (row within the group) and their BOUND words into
// s_bv.  Returns how many; every thread must call it.
template <int kBound, typename Keep>
__device__ __forceinline__ int stage_rows(const uint32_t* __restrict__ cols,
                                          int nv, long long r0, int rows,
                                          const Pattern& pat, Keep keep,
                                          int* s_idx,
                                          uint32_t (*s_bv)[kSJGroup],
                                          int* s_warp) {
  bool take[kSJRowsPerThread];
  int mine = 0;
#pragma unroll
  for (int q = 0; q < kSJRowsPerThread; ++q) {
    const int i = threadIdx.x * kSJRowsPerThread + q;
    take[q] = i < rows && keep(r0 + i);
    mine += take[q];
  }
  int total;
  int at = block_exclusive_scan(mine, s_warp, &total);
#pragma unroll
  for (int q = 0; q < kSJRowsPerThread; ++q) {
    if (!take[q]) continue;
    const int i = threadIdx.x * kSJRowsPerThread + q;
    const uint32_t* crow = cols + (size_t)(r0 + i) * nv;
    s_idx[at] = i;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (kBound & (1 << k)) s_bv[k][at] = crow[pat.var[k]];
    ++at;
  }
  __syncthreads();
  return total;
}

// Count pass: part[tile][row] = matches of the row in the block's tile
// (every row of a group with a live row), counts[row] += it.
template <int kBound>
__global__ void __launch_bounds__(kSJThreads)
scan_join_count_kernel(const uint32_t* __restrict__ cols,
                       const uint8_t* __restrict__ bvalid, int WM, int nv,
                       const uint32_t* __restrict__ ks,
                       const uint32_t* __restrict__ kp,
                       const uint32_t* __restrict__ ko,
                       const uint8_t* __restrict__ kvalid, int N, Pattern pat,
                       int* __restrict__ part, int* __restrict__ counts) {
  __shared__ uint32_t s_bv[3][kSJGroup];
  __shared__ int s_idx[kSJGroup];
  __shared__ int s_cnt[kSJGroup];
  __shared__ int s_warp[kSJWarps];
  const long long r0 = (long long)blockIdx.y * kSJGroup;
  const int rows = (int)min((long long)kSJGroup, (long long)WM - r0);
  const int n = stage_rows<kBound>(
      cols, nv, r0, rows, pat,
      [&](long long r) { return bvalid[r] != 0; }, s_idx, s_bv, s_warp);
  if (n == 0) return;                           // no live row in the group

  uint32_t a[kSJRun], b[kSJRun], c[kSJRun];
  const unsigned ok = load_run(ks, kp, ko, kvalid, N, pat, a, b, c);
  for (int i = threadIdx.x; i < kSJGroup; i += kSJThreads) s_cnt[i] = 0;
  if (__syncthreads_or(ok != 0u)) {
    if (__any_sync(kFull, ok != 0u)) {          // warp-uniform
      for (int j = 0; j < n; ++j) {
        const uint32_t b0 = (kBound & 1) ? s_bv[0][j] : 0u;
        const uint32_t b1 = (kBound & 2) ? s_bv[1][j] : 0u;
        const uint32_t b2 = (kBound & 4) ? s_bv[2][j] : 0u;
        if (!__any_sync(kFull, any_bound<kBound>(a, b, c, b0, b1, b2)))
          continue;                             // warp-uniform
        const unsigned bits = bound_bits<kBound>(a, b, c, b0, b1, b2) & ok;
        const int cnt = (int)__reduce_add_sync(kFull, (unsigned)__popc(bits));
        if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_cnt[s_idx[j]], cnt);
      }
    }
    __syncthreads();
  }
  int* prow = part + (size_t)blockIdx.x * WM + r0;
  for (int i = threadIdx.x; i < rows; i += kSJThreads) {
    const int v = s_cnt[i];
    prow[i] = v;
    if (v) atomicAdd(counts + r0 + i, v);
  }
}

// Scatter pass: the rows with matches in the block's tile and an offset
// below out_cap write their matches at offset + (earlier tiles) + rank.
template <int kBound>
__global__ void __launch_bounds__(kSJThreads)
scan_join_scatter_kernel(const uint32_t* __restrict__ cols,
                         const uint8_t* __restrict__ bvalid, int WM, int M,
                         int nv, const uint32_t* __restrict__ ks,
                         const uint32_t* __restrict__ kp,
                         const uint32_t* __restrict__ ko,
                         const uint8_t* __restrict__ kvalid, int N,
                         Pattern pat, const int* __restrict__ part,
                         const long long* __restrict__ offsets,
                         uint32_t* __restrict__ out, int out_cap) {
  __shared__ uint32_t s_bv[3][kSJGroup];
  __shared__ int s_idx[kSJGroup];
  __shared__ int s_warp[kSJWarps];
  __shared__ int s_wc[2][kSJWarps], s_wp[2][kSJWarps];
  const int t = blockIdx.x;
  const long long r0 = (long long)blockIdx.y * kSJGroup;
  const int rows = (int)min((long long)kSJGroup, (long long)WM - r0);
  const int* ptile = part + (size_t)t * WM;
  const int n = stage_rows<kBound>(
      cols, nv, r0, rows, pat,
      [&](long long r) {
        return bvalid[r] != 0 && ptile[r] > 0 && offsets[r] < out_cap;
      },
      s_idx, s_bv, s_warp);
  if (n == 0) return;                           // nothing to write here

  uint32_t a[kSJRun], b[kSJRun], c[kSJRun];
  const unsigned ok = load_run(ks, kp, ko, kvalid, N, pat, a, b, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    const long long r = r0 + s_idx[j];
    int before = 0;                             // the row's earlier tiles
    for (int tt = threadIdx.x; tt < t; tt += kSJThreads)
      before += part[(size_t)tt * WM + r];
    const unsigned bits =
        bound_bits<kBound>(a, b, c, (kBound & 1) ? s_bv[0][j] : 0u,
                           (kBound & 2) ? s_bv[1][j] : 0u,
                           (kBound & 4) ? s_bv[2][j] : 0u) & ok;
    const int cnt = __popc(bits);
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int wb = (int)__reduce_add_sync(kFull, (unsigned)before);
    const int buf = j & 1;        // two buffers: one barrier a row suffices
    if (lane == 31) s_wc[buf][warp] = x;
    if (lane == 0) s_wp[buf][warp] = wb;
    __syncthreads();
    if (!bits) continue;
    long long pos = offsets[r] + (x - cnt);
#pragma unroll
    for (int i = 0; i < kSJWarps; ++i)
      pos += s_wp[buf][i] + (i < warp ? s_wc[buf][i] : 0);
    if (pos >= out_cap) continue;
    const uint32_t* crow = cols + (size_t)r * nv;
    uint32_t* obase = out + (size_t)(r / M) * out_cap * nv;
#pragma unroll
    for (int k = 0; k < kSJRun; ++k) {
      if ((bits >> k) & 1u) {
        if (pos < out_cap)
          write_row(obase + (size_t)pos * nv, crow, nv, pat, a[k], b[k], c[k]);
        ++pos;
      }
    }
  }
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

struct SJArgs {
  const uint32_t* cols;
  const uint8_t* bvalid;
  int WM, M, nv;
  const uint32_t *ks, *kp, *ko;
  const uint8_t* kvalid;
  int N;
  Pattern pat;
  int* part;
  int* counts;
  const long long* offsets;
  uint32_t* out;
  int out_cap;
};

template <int kBound>
void launch_scan_join(int phase, dim3 grid, cudaStream_t st, const SJArgs& a) {
  if (phase == 0) {
    scan_join_count_kernel<kBound><<<grid, kSJThreads, 0, st>>>(
        a.cols, a.bvalid, a.WM, a.nv, a.ks, a.kp, a.ko, a.kvalid, a.N, a.pat,
        a.part, a.counts);
  } else {
    scan_join_scatter_kernel<kBound><<<grid, kSJThreads, 0, st>>>(
        a.cols, a.bvalid, a.WM, a.M, a.nv, a.ks, a.kp, a.ko, a.kvalid, a.N,
        a.pat, a.part, a.offsets, a.out, a.out_cap);
  }
}

}  // namespace

extern "C" {

int scan_join_tile_rows() { return kSJTile; }
int scan_join_group_rows() { return kSJGroup; }

// phase: 0 = count (writes part [tiles, W*M] and adds to counts [W, M]),
// 1 = scatter (reads part and offsets, writes out).  The grid is sized
// from the shapes alone: tiles of the KB on x, groups of binding rows on y.
int scan_join_launch(int phase, const void* cols, const void* bvalid, int W,
                     int M, int nv, const void* ks, const void* kp,
                     const void* ko, const void* kvalid, int N, int s_mode,
                     unsigned s_cst, int s_var, int p_mode, unsigned p_cst,
                     int p_var, int o_mode, unsigned o_cst, int o_var,
                     int eq01, int eq02, int eq12, void* part, void* counts,
                     const void* offsets, void* out, int out_cap,
                     void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  const long long wm = (long long)W * M;
  const long long groups = (wm + kSJGroup - 1) / kSJGroup;
  if (groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const Pattern pat = make_pattern(s_mode, s_cst, s_var, p_mode, p_cst, p_var,
                                   o_mode, o_cst, o_var, eq01, eq02, eq12);
  const int bound = (s_mode == 1) | ((p_mode == 1) << 1) | ((o_mode == 1) << 2);
  const dim3 grid((unsigned)(((long long)N + kSJTile - 1) / kSJTile),
                  (unsigned)groups);
  const SJArgs args{(const uint32_t*)cols, (const uint8_t*)bvalid, (int)wm, M,
                    nv, (const uint32_t*)ks, (const uint32_t*)kp,
                    (const uint32_t*)ko, (const uint8_t*)kvalid, N, pat,
                    (int*)part, (int*)counts, (const long long*)offsets,
                    (uint32_t*)out, out_cap};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bound) {
    case 0: launch_scan_join<0>(phase, grid, st, args); break;
    case 1: launch_scan_join<1>(phase, grid, st, args); break;
    case 2: launch_scan_join<2>(phase, grid, st, args); break;
    case 3: launch_scan_join<3>(phase, grid, st, args); break;
    case 4: launch_scan_join<4>(phase, grid, st, args); break;
    case 5: launch_scan_join<5>(phase, grid, st, args); break;
    case 6: launch_scan_join<6>(phase, grid, st, args); break;
    default: launch_scan_join<7>(phase, grid, st, args); break;
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
