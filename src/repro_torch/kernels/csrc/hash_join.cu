// Window-vs-KB joins for Hopper (sm_90a): the fused scan join and the fused
// probe join, each as count -> exclusive scan -> scatter (the probe join in
// one launch), and the unfused scan join's candidate matrix.
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
// that writes every match at its offset (the scan join re-derives its
// matches there; the probe join keeps what its count found).  The result is
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
// Probe join.  Its bytes are a few KB a call (the live rows' anchors, a
// few keys and KB words a live row, the output): what bounds it on this card
// is the chain of dependent loads of each live row's binary search over the
// ~N-key view (log2 N round trips to L2 for a plain lower bound) and the
// launches around it.  Design, one launch:
//   * a cluster of C <= 8 blocks per window (grid (C, W)).  Every block
//     ranks the window's live rows (its validity, eight bytes a thread, one
//     block scan per 4096 rows) and takes an equal share of them by rank,
//     however they lie (the path's tables hold their live rows in front).
//     Only live rows search: dead rows, and their fan-out, cost nothing;
//   * one search, no upper bound.  The candidates are lo .. lo + k_max - 1
//     where the key equals q (the view is sorted), and the fan-out flag is
//     keys[lo + k_max] == q: both come from the k_max + 1 keys after lo,
//     read eight at a time with the candidates' KB words.  lo itself comes
//     from a fence table, every 2^shift-th key of the view, built once per
//     KB (KnowledgeBase.fences) and staged whole into shared memory by one
//     bulk copy (cp.async.bulk, completion on an mbarrier) that overlaps the
//     ranking.  The fences give the 64-key segment holding lo (shift 6; a
//     larger view takes a larger shift, its segment halved in device memory
//     first), read as sixteen 16-byte loads and counted.  Within each of
//     these steps a thread's loads are issued together, with no branch
//     between them (a load past the view reads a clamped address and is
//     masked): a load that waits on a branch serialises its round trip;
//   * count -> offsets -> scatter in the same launch: each row with matches
//     keeps (row, lo, match bits, its offset in the block) in shared memory
//     (1024 rows a block; past that the scatter searches those rows again);
//     every block pushes its count into the others' shared memory
//     (distributed shared memory; a split barrier begun at the start has
//     shown that they all run), and after one cluster barrier each reads
//     its window offset and the window's total from its own.
//     Matches are written while below out_cap, the window's valid flags and
//     zero tail are striped over the cluster's blocks, and block 0 writes
//     overflow = bind overflow | total > out_cap | any live row's fan-out;
//   * no conversions: the kernel reads the int64 binding ids (their low
//     words) and writes int64 rows (binding words copied, FREE slots the KB
//     words zero-extended), so the wrapper only allocates its outputs.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
// the block's total, for a block of kWarps warps.  Every thread must call it.
template <int kWarps>
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
  for (int i = 0; i < kWarps; ++i) {
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
  int at = block_exclusive_scan<kSJWarps>(mine, s_warp, &total);
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

constexpr int kPJThreads = 512;
constexpr int kPJWarps = kPJThreads / 32;
constexpr int kPJEntries = 1024;     // rows with matches a block keeps
constexpr int kPJMaxCluster = 8;     // the portable cluster size
constexpr int kPJMaxFences = 32768;  // fence words a block can stage (128 KB)
constexpr int kPJSeg = 64;           // keys a thread counts at the end
constexpr int kPJCntBits = 20;       // packed scan: rows << 20 | matches

struct ProbeArgs {
  const long long* cols;     // [W, M, nv] int64-held uint32 ids
  const uint8_t* bvalid;     // [W, M]
  const uint8_t* bovf;       // [W]
  int M, nv;
  const uint32_t *vs, *vp, *vo, *keys;   // the sorted view, N rows
  int N;
  const uint32_t* fences;    // keys[i << shift], F of them, padded to 4
  int F, shift;
  Pattern pat;
  int anchor;
  uint32_t p_const;
  int k_max;
  long long* rows;           // [W, out_cap, nv]
  uint8_t* valid;            // [W, out_cap]
  uint8_t* overflow;         // [W]
  int out_cap;
};

// Number of fences below q; branchless, so a warp's lanes step together.
__device__ __forceinline__ int fence_rank(const uint32_t* f, int F,
                                          uint32_t q) {
  if (F == 0) return 0;
  const uint32_t* b = f;
  int n = F;
  while (n > 1) {
    const int half = n >> 1;
    b = b[half] < q ? b + half : b;
    n -= half;
  }
  return (int)(b - f) + (*b < q);
}

// searchsorted(keys, q, "left") over the whole view.  The fence table gives
// a segment [a, b) with keys[a] < q <= keys[b] (or b == N); a segment wider
// than kPJSeg keys (fences sparser than every 64th key) is halved in device
// memory down to kPJSeg keys, which are then counted.  kVec (the keys
// 16-byte aligned, shift >= 2, N >= 4): sixteen 16-byte loads, issued
// together (no branch between them: a chunk past the last whole one reads
// that one and is masked), plus the ragged last keys where the segment
// reaches them.
template <bool kVec>
__device__ __forceinline__ int probe_lo(const uint32_t* __restrict__ keys,
                                        int N, const uint32_t* s_fence,
                                        int F, int shift, uint32_t q) {
  const int j = fence_rank(s_fence, F, q);
  if (j == 0) return 0;
  int a = (j - 1) << shift;
  int b = (int)min((long long)j << shift, (long long)N);
  while (b - a > kPJSeg) {            // a stays a multiple of kPJSeg
    int mid = (a + ((b - a) >> 1)) & ~(kPJSeg - 1);
    if (mid <= a) mid = a + kPJSeg;
    if (__ldg(keys + mid) < q) a = mid; else b = mid;
  }
  int below = 0;
  if (kVec) {
    const uint4* vkeys = reinterpret_cast<const uint4*>(keys);
    const int whole = N >> 2;           // whole 16-byte chunks
    uint4 v[kPJSeg / 4];
#pragma unroll
    for (int i = 0; i < kPJSeg / 4; ++i)
      v[i] = __ldg(vkeys + min((a >> 2) + i, whole - 1));
#pragma unroll
    for (int i = 0; i < kPJSeg / 4; ++i) {
      const int e = a + 4 * i;
      if (e + 4 <= 4 * whole) {
        below += (e < b && v[i].x < q) + (e + 1 < b && v[i].y < q) +
                 (e + 2 < b && v[i].z < q) + (e + 3 < b && v[i].w < q);
      }
    }
    for (int e = 4 * whole; e < b; ++e) below += __ldg(keys + e) < q;
  } else {
    for (int e = a; e < b; ++e) below += __ldg(keys + e) < q;
  }
  return a + below;
}

struct RowProbe {
  int r, lo;
  unsigned long long mask;   // bit t: candidate lo + t matches
  bool fan;                  // the key's run is longer than k_max
};

// Probe one live row: the lower bound, then the keys lo .. lo + k_max eight
// at a time (candidate t < k_max is in the range iff its key is q, as the
// view is sorted; key k_max flags fan-out) with the candidates' words, all
// loads of the eight issued together, and the exact re-check of the CONST
// and BOUND slots (a key's low bits may be a hash of the term).
template <bool kVec>
__device__ __forceinline__ RowProbe probe_row(const ProbeArgs& A, int w,
                                              int r, const uint32_t* s_fence) {
  RowProbe p{r, 0, 0ull, false};
  const Pattern& pat = A.pat;
  const long long* crow = A.cols + ((size_t)w * A.M + r) * A.nv;
  uint32_t bv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    bv[i] = pat.mode[i] == 1 ? (uint32_t)crow[pat.var[i]] : 0u;
  const uint32_t anchor =
      A.anchor == 0 ? (pat.mode[0] == 0 ? pat.cst[0] : bv[0])
                    : (pat.mode[2] == 0 ? pat.cst[2] : bv[2]);
  const uint32_t q = composite_key(A.p_const, anchor);
  p.lo = probe_lo<kVec>(A.keys, A.N, s_fence, A.F, A.shift, q);
  const bool chk_s = pat.mode[0] != 2, chk_o = pat.mode[2] != 2;
  for (int tk = 0; tk <= A.k_max; tk += 8) {
    uint32_t kk[8], s[8], pp[8], o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = tk + u, idx = min(p.lo + t, A.N - 1);
      const bool in = t <= A.k_max && p.lo + t < A.N;
      kk[u] = in ? __ldg(A.keys + idx) : ~q;
      s[u] = chk_s && in ? __ldg(A.vs + idx) : 0u;
      pp[u] = in ? __ldg(A.vp + idx) : 0u;
      o[u] = chk_o && in ? __ldg(A.vo + idx) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = tk + u;
      const bool eq = kk[u] == q;
      if (t == A.k_max) p.fan = eq;
      const bool m = eq && t < A.k_max &&
                     slot_ok(pat.mode[0], s[u], pat.cst[0], bv[0]) &&
                     slot_ok(pat.mode[1], pp[u], pat.cst[1], bv[1]) &&
                     slot_ok(pat.mode[2], o[u], pat.cst[2], bv[2]);
      p.mask |= (unsigned long long)m << (t & 63);
    }
    if (kk[7] != q) break;
  }
  return p;
}

// The live rows of window w whose rank (their order among the window's live
// rows) is in [lr0, lr1), in row order, handed to fn(rows, n) a tile of at
// most kPJThreads at a time.  The window's validity is read in sweeps of
// kPJSweep rows, eight bytes a thread, ranked by one block scan a sweep.
// fn returns whether to go on.  Every thread must call it.
constexpr int kPJSweep = kPJThreads * 8;
template <typename Fn>
__device__ __forceinline__ void live_tiles(const ProbeArgs& A, int w, int lr0,
                                           int lr1, int* s_live, int* s_warp,
                                           Fn fn) {
  const uint8_t* vrow = A.bvalid + (size_t)w * A.M;
  int rank0 = 0;                        // live rows before the sweep
  for (int s0 = 0; s0 < A.M && rank0 < lr1; s0 += kPJSweep) {
    const int r = s0 + 8 * (int)threadIdx.x;
    uint8_t v[8];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v[u] = r + u < A.M ? vrow[r + u] : 0;
      mine += v[u] != 0;
    }
    int tot;
    int k = rank0 + block_exclusive_scan<kPJWarps>(mine, s_warp, &tot);
    const int first = max(lr0, rank0), last = min(lr1, rank0 + tot);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!v[u]) continue;
      if (k >= first && k < last) s_live[k - first] = r + u;
      ++k;
    }
    __syncthreads();
    for (int t0 = 0; t0 < last - first; t0 += kPJThreads)
      if (!fn(s_live + t0, min(kPJThreads, last - first - t0))) return;
    rank0 += tot;
    __syncthreads();                    // s_live is rewritten next sweep
  }
}

// The window's live rows (every block counts them alike).
__device__ __forceinline__ int live_count(const ProbeArgs& A, int w,
                                          int* s_warp) {
  const uint8_t* vrow = A.bvalid + (size_t)w * A.M;
  int total = 0;
  for (int s0 = 0; s0 < A.M; s0 += kPJSweep) {
    const int r = s0 + 8 * (int)threadIdx.x;
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) mine += r + u < A.M && vrow[r + u];
    int tot;
    block_exclusive_scan<kPJWarps>(mine, s_warp, &tot);
    total += tot;
  }
  return total;
}

// Row r's matches (the bits of mask, candidates from lo) written from
// window position pos on, while below out_cap: the binding row's int64
// words, then the FREE slots' KB words zero-extended.
__device__ __forceinline__ void write_matches(const ProbeArgs& A, int w,
                                              int r, int lo,
                                              unsigned long long mask,
                                              long long pos) {
  const long long* crow = A.cols + ((size_t)w * A.M + r) * A.nv;
  const Pattern& pat = A.pat;
  for (; mask && pos < A.out_cap; mask &= mask - 1, ++pos) {
    const int idx = lo + __ffsll((long long)mask) - 1;
    long long* orow = A.rows + ((size_t)w * A.out_cap + pos) * A.nv;
    for (int k = 0; k < A.nv; ++k) orow[k] = crow[k];
    if (pat.mode[0] == 2) orow[pat.var[0]] = (long long)__ldg(A.vs + idx);
    if (pat.mode[1] == 2) orow[pat.var[1]] = (long long)__ldg(A.vp + idx);
    if (pat.mode[2] == 2) orow[pat.var[2]] = (long long)__ldg(A.vo + idx);
  }
}

// grid (C, W), cluster (C, 1, 1): the cluster owns window w, and its block
// c the live rows of rank [c L / C, (c + 1) L / C) of the window's L, so
// the blocks share the work however the live rows lie.  Count (keeping
// each row with matches in shared memory), offsets through distributed
// shared memory, scatter, then the window's zero tail, valid and overflow,
// in one launch.  Every block reaches every cluster barrier.
template <bool kVec>
__global__ void __launch_bounds__(kPJThreads)
probe_join_kernel(const ProbeArgs A) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int w = blockIdx.y, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char pj_smem[];
  const int fpad = (A.F + 3) & ~3;
  uint32_t* s_fence = reinterpret_cast<uint32_t*>(pj_smem);
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(s_fence + fpad);
  int* s_row = reinterpret_cast<int*>(s_mask + kPJEntries);
  int* s_lo = s_row + kPJEntries;
  int* s_pre = s_lo + kPJEntries;       // the row's first match in the block
  int* s_live = s_pre + kPJEntries;     // [kPJSweep]
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_warp[kPJWarps];
  __shared__ long long s_counts[kPJMaxCluster];   // every block's, pushed
  __shared__ int s_fans[kPJMaxCluster];           // by the blocks

  // every block has started once this phase completes: the counts pushed
  // into the others' shared memory below find it there
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // stage the fence table (one bulk copy) while the validity is ranked
  const bool stage = A.F > 0 && A.M > 0;
  const uint32_t bar = smem_u32(&s_bar);
  if (tid == 0 && stage) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(fpad * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(s_fence)), "l"(A.fences), "r"(fpad * 4), "r"(bar)
        : "memory");
  }
  const int L = live_count(A, w, s_warp);     // its scans order the init
  const int lr0 = (int)((long long)L * c / C);
  const int lr1 = (int)((long long)L * (c + 1) / C);

  // count: the block's matches so far, the rows kept, and where the rows
  // stopped fitting (the scatter probes again for the rows from there)
  long long count = 0, spill_base = -1;
  int kept_rows = 0;
  bool fan = false;
  live_tiles(A, w, lr0, lr1, s_live, s_warp, [&](const int* rows, int n) {
    RowProbe p{-1, 0, 0ull, false};
    if (tid < n) {
      if (stage) mbar_wait(bar, 0);   // the fence table has landed
      p = probe_row<kVec>(A, w, rows[tid], s_fence);
    }
    const int cnt = __popcll(p.mask);
    int tot;
    const int ex = block_exclusive_scan<kPJWarps>(
        (cnt > 0 ? 1 << kPJCntBits : 0) | cnt, s_warp, &tot);
    const int tile_rows = tot >> kPJCntBits;
    if (spill_base < 0 && kept_rows + tile_rows > kPJEntries)
      spill_base = count;
    if (spill_base < 0) {
      if (cnt > 0) {
        const int e = kept_rows + (ex >> kPJCntBits);
        s_row[e] = p.r;
        s_lo[e] = p.lo;
        s_mask[e] = p.mask;
        s_pre[e] = (int)count + (ex & ((1 << kPJCntBits) - 1));
      }
      kept_rows += tile_rows;
    }
    count += tot & ((1 << kPJCntBits) - 1);
    fan = fan || p.fan;
    return true;
  });
  if (stage && tid == 0) mbar_wait(bar, 0);    // no copy left in flight
  const int block_fan = __syncthreads_or(fan);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < C) {                        // push (count, fan) to block tid
    *cluster.map_shared_rank(&s_counts[c], tid) = count;
    *cluster.map_shared_rank(&s_fans[c], tid) = block_fan;
  }
  cluster.sync();                       // the pushes have landed; no remote
  long long base = 0, total = 0;        // access follows, so no barrier at
  int any_fan = 0;                      // the end
  for (int r = 0; r < C; ++r) {
    total += s_counts[r];
    base += r < c ? s_counts[r] : 0;
    any_fan |= s_fans[r];
  }

  // scatter the kept rows; past them, probe again and write the rows whose
  // offset in the block is from spill_base on
  for (int e = tid; e < kept_rows; e += kPJThreads)
    write_matches(A, w, s_row[e], s_lo[e], s_mask[e], base + s_pre[e]);
  if (spill_base >= 0) {
    long long run = 0;
    live_tiles(A, w, lr0, lr1, s_live, s_warp, [&](const int* rows, int n) {
      RowProbe p{-1, 0, 0ull, false};
      if (tid < n) p = probe_row<kVec>(A, w, rows[tid], s_fence);
      const int cnt = __popcll(p.mask);
      int tot;
      const long long off =
          run + block_exclusive_scan<kPJWarps>(cnt, s_warp, &tot);
      if (cnt > 0 && off >= spill_base)
        write_matches(A, w, p.r, p.lo, p.mask, base + off);
      run += tot;
      return base + run < A.out_cap;
    });
  }

  // the window's valid flags, and its zero tail as 16-byte stores over the
  // tail's flat int64 words, striped over the cluster
  const long long kept = min(total, (long long)A.out_cap);
  const long long stride = (long long)C * kPJThreads;
  const long long first = (long long)c * kPJThreads + tid;
  for (long long k = first; k < A.out_cap; k += stride)
    A.valid[(size_t)w * A.out_cap + k] = k < kept;
  long long* wrows = A.rows + (size_t)w * A.out_cap * A.nv;
  const long long z0 = kept * A.nv, z1 = (long long)A.out_cap * A.nv;
  const long long za = min(z1, z0 + (long long)(
      (reinterpret_cast<uintptr_t>(wrows + z0) & 15u) != 0));
  const long long pairs = (z1 - za) >> 1;
  uint4* zv = reinterpret_cast<uint4*>(wrows + za);
  for (long long i = first; i < pairs; i += stride)
    zv[i] = make_uint4(0u, 0u, 0u, 0u);
  if (first == 0 && za > z0) wrows[z0] = 0;      // the word before them
  if (first == 1 && za + 2 * pairs < z1) wrows[z1 - 1] = 0;   // and after
  if (c == 0 && tid == 0)
    A.overflow[w] = A.bovf[w] || total > A.out_cap || any_fan;
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

int probe_join_fence_limit() { return kPJMaxFences; }

// One launch: grid (C, W) of kPJThreads-thread blocks, cluster (C, 1, 1),
// C = ceil(M / kPJThreads) up to kPJMaxCluster.  Writes rows [W, out_cap,
// nv] (int64), valid [W, out_cap] and overflow [W] entirely: the caller
// allocates them without filling.
int probe_join_launch(const void* cols, const void* bvalid, const void* bovf,
                      int W, int M, int nv, const void* vs, const void* vp,
                      const void* vo, const void* keys, int N,
                      const void* fences, int F, int shift, int s_mode,
                      unsigned s_cst, int s_var, int p_mode, unsigned p_cst,
                      int p_var, int o_mode, unsigned o_cst, int o_var,
                      int anchor, int k_max, void* rows, void* valid,
                      void* overflow, int out_cap, void* stream) {
  if (W == 0) return 0;
  if (W > 65535 || F > kPJMaxFences || k_max < 1 || k_max > 64 ||
      (N > 0 && (long long)F << shift < N))
    return (int)cudaErrorInvalidValue;
  const int fpad = (F + 3) & ~3;
  const int C = max(1, min(kPJMaxCluster, (M + kPJThreads - 1) / kPJThreads));
  const size_t tail = (size_t)kPJEntries * (8 + 3 * 4) + kPJSweep * 4;
  // the function's attribute, once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    void (*fns[2])(const ProbeArgs) = {probe_join_kernel<true>,
                                        probe_join_kernel<false>};
    for (int i = 0; i < 2; ++i) {
      err = cudaFuncSetAttribute(fns[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(kPJMaxFences * 4 + tail));
      if (err != cudaSuccess) return (int)err;
    }
    if (dev < 32) ready |= 1u << dev;
  }
  ProbeArgs a;
  a.cols = (const long long*)cols;
  a.bvalid = (const uint8_t*)bvalid;
  a.bovf = (const uint8_t*)bovf;
  a.M = M;
  a.nv = nv;
  a.vs = (const uint32_t*)vs;
  a.vp = (const uint32_t*)vp;
  a.vo = (const uint32_t*)vo;
  a.keys = (const uint32_t*)keys;
  a.N = N;
  a.fences = (const uint32_t*)fences;
  a.F = F;
  a.shift = shift;
  a.pat = make_pattern(s_mode, s_cst, s_var, p_mode, p_cst, p_var, o_mode,
                       o_cst, o_var, 0, 0, 0);
  a.anchor = anchor;
  a.p_const = p_cst;
  a.k_max = k_max;
  a.rows = (long long*)rows;
  a.valid = (uint8_t*)valid;
  a.overflow = (uint8_t*)overflow;
  a.out_cap = out_cap;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, W);
  cfg.blockDim = dim3(kPJThreads);
  cfg.dynamicSmemBytes = (size_t)fpad * 4 + tail;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // 16-byte loads of the keys where they are aligned and the fences fall
  // on multiples of 4
  const bool vec = ((uintptr_t)keys & 15u) == 0 && shift >= 2 && N >= 4;
  err = cudaLaunchKernelEx(
      &cfg, vec ? probe_join_kernel<true> : probe_join_kernel<false>, a);
  if (err != cudaSuccess) return (int)err;
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
