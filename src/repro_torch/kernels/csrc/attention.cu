// Attention kernels for Hopper (sm_90a): the GQA flash-attention forward
// (prefill; bf16 on the tensor cores, float32 on the CUDA cores) and GQA
// decode attention (one query token against a KV cache, one launch whose
// splits merge in a thread-block cluster).  The cp.async, mbarrier and
// wgmma helpers are in hopper.cuh.
//
// Replaces the TPU kernels
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_pallas
//     (_flash_kernel: online softmax over a sequential KV grid axis, the
//      f32 max / denominator / accumulator in VMEM scratch, causal and
//      sliding-window masks, dead KV blocks skipped with pl.when)
//   src/repro/kernels/decode_attention/kernel.py  decode_attention_pallas
//     (_decode_kernel: one query row per (batch, query head), the cache
//      swept block by block along a sequential grid axis, blocks at or past
//      lengths[b] skipped).  The port's decode kernel also takes a sliding
//      window, each sequence's first live row max(0, lengths[b] - window):
//      the reference sends a windowed one-token step to flash attention,
//      which here would spend a 128-row query tile on one row.
//
// Head dims (D of q and k, Dv of v): (16, 16), (32, 32), (64, 64), (80, 80),
// (128, 128) and, for multi-head latent attention (MLA), (96, 64)
// (MiniCPM3-4B) and (192, 128) (DeepSeek-V2): q and k carry D = nope + rope
// columns, v the value width Dv below it; the scale stays 1/sqrt(D).  Any
// other pair is refused (kBadShape).  The bf16 flash kernel pads D and Dv to
// a multiple of 64 columns each (D = 80 and 96 to 128 in Q K^T, whose k-steps
// take only the live columns), the bf16 decode kernel its shared rows to
// whole groups of 8 16-byte chunks, the f32 decode kernel a row's lanes to a
// power of two (D / 4 lanes of 4 floats up to D = 128, D / 8 lanes of 8
// floats above: D = 192 takes 24 of 32 lanes).  At D = 192 the bf16 flash
// kernel fits one SM only because its V tiles are sized by Dv (48 KB of Q,
// 2 x 48 KB of K and 2 x 32 KB of V stages: 208 KB; with Dv = D it would be
// 240 KB), and the f32 flash kernel holds one block an SM where two do not
// fit.
//
// Layouts are the reference's: q [B, Hq, Tq, D], k [B, Hk, Tk, D], v [B, Hk,
// Tk, Dv], out [B, Hq, Tq, Dv], contiguous, in float32 or bfloat16.  Query
// head h reads KV head h / (Hq / Hk): K and V are never repeated in memory.
// All softmax arithmetic is float32, in base 2 (exp2 of scores times
// log2(e)/sqrt(D) is the same function as exp).
//
// Flash attention.  Bound at the prefill's shapes (B=4, Hq=12, Tq=2048
// over a 2112-row cache, D=128): 4·D operations per live (query, key)
// pair, 5.2e10 per layer, against ~59 MB of q, k, v and out: operations
// bound it, at the bf16 tensor-core peak (989e12/s: 0.052 ms).  The TPU
// walked KV blocks along a sequential grid axis with the statistics in
// VMEM; here a block owns one (batch, query head, query tile) and loops
// over the live KV tiles itself, its statistics in registers.  Tiles past
// the causal edge, before the window or past Tk are never loaded (the
// prefill attends over the whole cache, Tk = max_len, and the rows past
// the prompt cost nothing); query tiles are issued latest first, since
// they have the most KV tiles.  Masked entries are selected out (not left
// to exp2 underflow); a row with no live key writes zeros.  The wrapper
// picks the kernel by dtype (not a knob): bf16 takes the tensor cores,
// float32 the CUDA cores.
//
// flash_attention_wgmma_kernel (bf16).  A block of three warpgroups owns 128
// query rows of one (batch, head): two consumer warpgroups of 64 rows each
// (wgmma's M) and one producer warpgroup that copies Q once and then the live
// K and V tiles (128 rows) into a two-stage ring in shared memory with
// cp.async 16-byte copies.  The producers write every tile straight into the
// 128-byte-swizzled layout that wgmma's shared-memory descriptors read
// (64-column blocks, row r's 16-byte chunk c at c ^ r % 8; zero-filled past
// Tq, Tk and, for D < 64, past D).  mbarriers hand the stages over, K and V
// separately: a consumer multiplies Q K^T as soon as K has landed, while V is
// still in flight, and a stage's K is refilled as soon as both warpgroups
// have their scores; the two warpgroups wait on the copies, never on each
// other.  S = Q K^T is wgmma m64n128k16 from shared memory (K read K-major as
// it lies), f32 in registers; the online softmax runs on the accumulator
// fragment (each row's max and sum reduced over the 4 lanes that hold it),
// applies the scale to the f32 scores, not to q, which would round q a second
// time, masks only in the tiles that hold an edge, and skips rescaling O when
// no row max moved.  O += P V is wgmma with P converted to bf16 in registers
// as the A operand (the accumulator fragment of S is P V's A fragment) and V
// read from shared memory as an MN-major B.  P is rounded to bf16 there, as
// SDPA and FlashAttention-2/3 do; the row sums are taken on the f32 P.  The
// grid runs every head's latest query tile first, so the longest blocks start
// first.  Overlapping a warpgroup's softmax with its own P V product
// (FlashAttention-3) needs more than the 168 registers a thread that three
// warpgroups leave; with setmaxnreg it ran slower on an H100.
//
// flash_attention_kernel (float32).  TF32 wgmma would keep ~3 decimal digits,
// above the float32 tolerance (1e-4) that the card-against-CPU gate of the LM
// relies on, so float32 stays on the CUDA cores: one block of 256 threads
// owns a 64-row query tile and loops over 64-row KV tiles; each thread holds
// a 4 x 4 block of the score tile and the same 4 rows of the output (4 x D/16
// floats), row max and row sum reduced over the 16 lanes of a half-warp with
// shuffles.  Q is scaled by log2(e)/sqrt(D) once, in float32.  Q, K/V and P
// tiles are float32 in shared memory (row stride D + 4 floats: 16-byte
// aligned, and eight threads reading eight rows' float4s hit 32 distinct
// banks); K and V take turns in one buffer, which keeps two blocks on an SM
// up to D = 128 (at D = 192 one: 115 KB a block).  P stays float32 in P.V.
//
// Decode attention: one launch.  Bound: reading the K and V rows below
// lengths[b] once (8.5 MB per layer at B=4, Hk=2, D=128, length 2080: 2.5
// us at 3.35 TB/s); the arithmetic is ~1 operation per byte.  A block serves
// up to 8 query heads of one KV head, so each cache row is read once per 8
// heads (GQA groups above 8 take more blocks).  One block per (batch, KV
// head) would put 8 blocks on 132 SMs at B=4, so the live rows are cut into
// nsplit splits of whole 64-row tiles from the window's first tile (the
// wrapper picks nsplit: about two blocks per SM, at most a cluster of 8),
// and the nsplit blocks of a (batch, KV head) form one thread-block
// cluster; rows below the window's start in its first tile are masked.  Each block streams its split's K
// and V tiles, in their dtype, through a ring of 3-6 stages in shared
// memory with 16-byte cp.async copies, so the next tiles are in flight while
// one is consumed; each warp keeps its own running max, sum and accumulator
// per head, with no barrier but the ring's one a tile.  At the end the
// warps merge through shared memory and the cluster's blocks through
// distributed shared memory (decode_merge): after cluster.sync() each block
// merges a share of the (head, column) outputs from every block's (max,
// sum, accumulator) and writes it in the input dtype.  No float32 partial
// goes to device memory and nothing is allocated per call.  Every block
// reaches both cluster barriers, dead splits (at or past lengths[b])
// included; a row with no live key writes zeros.  The function's
// shared-memory and cluster attributes are set once per device.  The dtype
// picks the kernel:
//   decode_attention_mma_kernel (bf16): Q K^T and P V on the tensor cores
//     (mma.sync m16n8k16: at most 8 heads fill the 16-row M; wgmma's 64-row
//     M does not fit), P rounded to bf16 as in flash attention;
//   decode_attention_kernel (float32): on the CUDA cores, a lane owning a
//     16-byte chunk of a cache row (D/4 lanes a row; two chunks, D/8 lanes,
//     above D = 128), the query rows' chunks in float32 registers, a row's
//     scores summed over its lanes by shuffles.  On an H100 the first
//     design ran bf16 this way too: 4.4 us a 64-row tile at 8 warps,
//     issue-bound on the shuffles and FMAs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;            // query and KV tile rows
constexpr int kFlashThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadShape = -1;

// 16-byte loads of T, converted to float
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);      // round to nearest even, as torch's .to()
}

// rows [row0, row0 + nrows) of a row-major [*, D] matrix into dst (stride
// LD floats) as float times `scale`; rows at or past `limit` become zeros
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int nrows, int limit, float scale,
                                          int tid, int nthreads) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = D / N;             // vectors per row
  for (int i = tid; i < nrows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float f[N];
    if (row0 + r < limit) {
      Vec<T>::load(src + (size_t)(row0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + e) =
          make_float4(f[e] * scale, f[e + 1] * scale, f[e + 2] * scale,
                      f[e + 3] * scale);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// flash attention (prefill)
// ---------------------------------------------------------------------------

// Q and K/V rows (V's Dv <= D columns in a K-sized row); two blocks an SM
// where two fit (an SM's 228 KB less 1 KB a block), else one (D = 192: 115
// KB a block)
template <int D> struct FlashSmem {
  static constexpr int LD = D + 4;               // Q and K/V row stride
  static constexpr int LP = kTile + 4;           // P row stride
  static constexpr int floats = 2 * kTile * LD + kTile * LP;
  static constexpr int bytes = floats * 4;
  static constexpr int blocks = 2 * (bytes + 1024) <= 233472 ? 2 : 1;
};

template <int D, int DV>
__global__ void __launch_bounds__(kFlashThreads, FlashSmem<D>::blocks)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Hq, int Hk, int Tq, int Tk, int causal,
                       int has_window, int window, int q_offset,
                       float qscale) {
  static_assert(DV <= D && DV % 16 == 0, "flash value width");
  constexpr int LD = FlashSmem<D>::LD, LP = FlashSmem<D>::LP;
  constexpr int LKV = LD;                        // K and V rows
  constexpr int NC = DV / 16;                    // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [kTile][LD], scaled
  float* KVs = Qs + kTile * LD;                  // [kTile][LKV], K then V
  float* Ps = KVs + kTile * LKV;                 // [kTile][LP]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hk);
  const float* qb = q + (size_t)(b * Hq + hq) * Tq * D;
  const float* kb = k + (size_t)(b * Hk + hk) * Tk * D;
  const float* vb = v + (size_t)(b * Hk + hk) * Tk * DV;
  float* ob = o + (size_t)(b * Hq + hq) * Tq * DV;

  // output column of the thread's n-th accumulator
  auto col = [&](int n) {
    if constexpr (NC % 4 == 0) return 64 * (n / 4) + 4 * tx + n % 4;
    else return tx + 16 * n;
  };

  const int qpos0 = q_offset + q0;                        // first row
  const int qpos_last = q_offset + min(q0 + kTile, Tq) - 1;
  int kt_begin = 0, kt_end = (Tk + kTile - 1) / kTile;
  if (causal) kt_end = min(kt_end, qpos_last / kTile + 1);
  if (has_window) {
    const long long lo = (long long)qpos0 - window + 1;   // first live key
    if (lo > 0) kt_begin = (int)min(lo / kTile, (long long)kt_end);
  }

  load_rows<float, D, LD>(Qs, qb, q0, kTile, Tq, qscale, tid, kFlashThreads);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                     // KVs and Ps free, Qs visible
    load_rows<float, D, LKV>(KVs, kb, k0, kTile, Tk, 1.f, tid, kFlashThreads);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LKV + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qpos0 + ty * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < Tk && (!causal || kpos <= qpos) &&
                  (!has_window || (long long)kpos > (long long)qpos - window);
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? exp2f(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }

    __syncthreads();                     // K no longer read
    load_rows<float, DV, LKV>(KVs, vb, k0, kTile, Tk, 1.f, tid,
                              kFlashThreads);
    __syncthreads();                     // V and P visible

#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = KVs + (c + cc) * LKV;
        float vv[NC];
        if constexpr (NC % 4 == 0) {
#pragma unroll
          for (int n = 0; n < NC; n += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + col(n));
            vv[n] = t.x; vv[n + 1] = t.y; vv[n + 2] = t.z; vv[n + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int n = 0; n < NC; ++n) vv[n] = vrow[col(n)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(pv[i], cc);
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store(ob + (size_t)row * DV + col(n), acc[i][n] / lsafe);
  }
}

// ---------------------------------------------------------------------------
// flash attention, bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;           // query rows a block: 2 warpgroups x 64
constexpr int kWgBN = 128;           // KV tile rows
constexpr int kWgConsumers = 256;    // two warpgroups of 64 query rows
constexpr int kWgProducers = 128;    // one warpgroup of loaders
constexpr int kWgThreads = kWgConsumers + kWgProducers;

// Shared memory of the bf16 kernel.  Every tile is stored as DP/64 column
// blocks of 64 bf16 (128 bytes a row) in the layout wgmma's 128-byte
// swizzle reads: row r at r * 128 bytes, its 16-byte chunk c at
// (c ^ r % 8) * 16.  Q and K widths (D) and V widths (DV) are each
// zero-padded up to a multiple of 64 columns (D < 64 to 64, D = 80 and 96
// to 128: more shared memory, and for D = 80 more P V columns, while Q K^T
// takes only the live k-steps).  V stages sized by DV are what fit D = 192
// (Dv 128): 48 + 2 x 48 + 2 x 32 KB.
__host__ __device__ constexpr int pad64(int w) { return (w + 63) / 64 * 64; }

template <int D, int DV> struct WgSmem {
  static constexpr int DP = pad64(D), DVP = pad64(DV);
  static constexpr int Q = (DP / 64) * kWgBM * 128;     // bytes of Q
  static constexpr int K = (DP / 64) * kWgBN * 128;     // one K tile
  static constexpr int V = (DVP / 64) * kWgBN * 128;    // one V tile
  static constexpr int bars = Q + 2 * K + 2 * V;        // 8 mbarriers
  static constexpr int bytes = bars + 64 + 1024;        // + 1024 alignment
  static_assert(DVP <= 128 && bytes <= 232448, "bf16 flash tile shape");
};

// rows [row0, row0 + ROWS) of a row-major [*, W] bf16 matrix into dst in the
// swizzled layout of WgSmem (column block c / 8 at c / 8 * ROWS * 128
// bytes); rows at or past `limit` and the padding columns are zero-filled
template <int W, int ROWS>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int limit, int tid) {
  constexpr int CPR = pad64(W) / 8;                // 16-byte chunks a row
#pragma unroll 8
  for (int it = 0; it < ROWS * CPR / kWgProducers; ++it) {
    const int i = tid + it * kWgProducers;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < limit && c * 8 < W;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * W + c * 8 : src;
    cp_async16(dst + (c >> 3) * ROWS * 128 + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               s, ok ? 16 : 0);
  }
}

// online softmax in base 2 on a [64, N] f32 score fragment in the wgmma
// accumulator layout: each row's max and sum over the 4 lanes that hold it,
// the scale applied to the f32 scores, masked entries (EDGE tiles only)
// selected out; P goes to bf16 pairs, p[4 kk .. 4 kk + 3] the A fragment of
// P V's k-step kk (keys 16 kk .. 16 kk + 15)
template <bool EDGE, int N>
__device__ __forceinline__ void online_softmax(float* s, uint32_t* p,
                                               float* m, float* l,
                                               float* alpha, float scale,
                                               int k0, int tig, const int* lo,
                                               const int* hi) {
  if constexpr (EDGE) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
        if (kpos <= lo[e >> 1] || kpos > hi[e >> 1])
          s[4 * j + e] = -CUDART_INF_F;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale);
    alpha[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = s[4 * j + 2 * h], x1 = s[4 * j + 2 * h + 1];
      float p0 = fast_exp2(fmaf(x0, scale, -m[h]));
      float p1 = fast_exp2(fmaf(x1, scale, -m[h]));
      if constexpr (EDGE) {
        p0 = x0 == -CUDART_INF_F ? 0.f : p0;
        p1 = x1 == -CUDART_INF_F ? 0.f : p1;
      }
      l[h] += p0 + p1;
      p[2 * j + h] = pack_bf16(p0, p1);
    }
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int Hq, int Hk,
                             int Tq, int Tk, int causal, int has_window,
                             int window, int q_offset, float scale) {
  using S = WgSmem<D, DV>;
  constexpr int DVP = S::DVP;
  constexpr int KQ = (D + 15) / 16;      // Q K^T's k-steps: the live columns
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t sQ = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + S::Q;                 // 2 stages of K
  const uint32_t sV = sK + 2 * S::K;             // 2 stages of V
  // fullk/fullv[st]: the stage's K / V landed (an arrival per producer
  // warp); emptyk/emptyv[st]: every consumer thread is done with it
  const uint32_t fullk = sQ + S::bars, fullv = fullk + 16;
  const uint32_t emptyk = fullv + 16, emptyv = emptyk + 16;

  const int tid = threadIdx.x;
  const int nq = (Tq + kWgBM - 1) / kWgBM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kWgBM;    // latest tiles first
  const int hq = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = hq / (Hq / Hk);
  const __nv_bfloat16* kb = k + (size_t)(b * Hk + hk) * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hk + hk) * Tk * DV;

  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + kWgBM, Tq) - 1;
  int kt_begin = 0, kt_end = (Tk + kWgBN - 1) / kWgBN;
  if (causal) kt_end = min(kt_end, qpos_last / kWgBN + 1);
  if (has_window) {
    const long long lo = (long long)qpos_first - window + 1;  // first live key
    if (lo > 0) kt_begin = (int)min(lo / kWgBN, (long long)kt_end);
  }
  const int ntiles = kt_end - kt_begin;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(fullk + 8 * i, kWgProducers / 32);
      mbar_init(fullv + 8 * i, kWgProducers / 32);
      mbar_init(emptyk + 8 * i, kWgConsumers);
      mbar_init(emptyv + 8 * i, kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    // producer warpgroup: Q with the first K, then every live K and V tile
    // into its stage once the consumers released the stage; K_j is
    // announced when it lands, V_j once K_{j+1} is in flight
    const int ptid = tid - kWgConsumers;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it & 1, round = it >> 1;
      const int k0 = (kt_begin + it) * kWgBN;
      if (round > 0) mbar_wait(emptyk + 8 * st, (round - 1) & 1);
      if (it == 0)
        load_tile_sw128<D, kWgBM>(
            sQ, q + (size_t)(b * Hq + hq) * Tq * D, q0, Tq, ptid);
      load_tile_sw128<D, kWgBN>(sK + st * S::K, kb, k0, Tk, ptid);
      cp_async_commit();
      if (it > 0) {
        cp_async_wait<1>();            // V of the previous tile landed
        fence_proxy_async();
        __syncwarp();
        if (ptid % 32 == 0) mbar_arrive(fullv + 8 * (st ^ 1));
      }
      if (round > 0) mbar_wait(emptyv + 8 * st, (round - 1) & 1);
      load_tile_sw128<DV, kWgBN>(sV + st * S::V, vb, k0, Tk, ptid);
      cp_async_commit();
      cp_async_wait<1>();              // this tile's K (and Q) landed
      fence_proxy_async();
      __syncwarp();
      if (ptid % 32 == 0) mbar_arrive(fullk + 8 * st);
    }
    if (ntiles > 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncwarp();
      if (ptid % 32 == 0) mbar_arrive(fullv + 8 * ((ntiles - 1) & 1));
    }
    return;
  }

  // consumer warpgroup wg: 64 query rows.  The thread's two rows (wgmma
  // accumulator layout: warp w of the warpgroup holds rows 16w..16w+15,
  // lane rows gid and gid + 8, columns 8j + 2 tig, +1); live keys
  // lo < kpos <= hi
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int row_local = wg * 64 + warp * 16 + gid;
  int hi[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qpos_first + row_local + 8 * h;
    hi[h] = causal ? min(Tk - 1, qpos) : Tk - 1;
    lo[h] = has_window ? (int)max((long long)qpos - window, -1LL) : -1;
  }
  const uint32_t qw = sQ + wg * 64 * 128;        // this warpgroup's Q rows

  float oacc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[kWgBN / 4];               // P in bf16 pairs: A fragments of P V

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, round = it >> 1;
    const int k0 = (kt_begin + it) * kWgBN;
    const uint32_t ks = sK + st * S::K, vs = sV + st * S::V;

    // S = Q K^T, [64 rows, kWgBN keys] in f32 registers
    float s[kWgBN / 2];
    mbar_wait(fullk + 8 * st, round & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      wgmma_ss_n128(s,
                    sw128_desc(qw + (kk / 4) * kWgBM * 128 + (kk % 4) * 32, 16),
                    sw128_desc(ks + (kk / 4) * kWgBN * 128 + (kk % 4) * 32, 16),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<kWgBN / 2>(s);
    mbar_arrive(emptyk + 8 * st);

    // only tiles on the causal edge, the window's edge or past Tk mask
    if (k0 + kWgBN > Tk || (causal && k0 + kWgBN - 1 > qpos_first) ||
        (has_window && (long long)k0 <= (long long)qpos_last - window))
      online_softmax<true, kWgBN>(s, p, m, l, alpha, scale, k0, tig, lo, hi);
    else
      online_softmax<false, kWgBN>(s, p, m, l, alpha, scale, k0, tig, lo, hi);
    // O *= alpha, skipped when no row max of the warp moved
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V, V [kWgBN keys, DVP] the MN-major B operand
    mbar_wait(fullv + 8 * st, round & 1);
    reg_fence<DVP / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 128, kWgBN * 128);
      if constexpr (DVP == 64) wgmma_rs_n64(oacc, &p[4 * kk], dv);
      else wgmma_rs_n128(oacc, &p[4 * kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DVP / 2>(oacc);
    mbar_arrive(emptyv + 8 * st);
  }

  __nv_bfloat16* ob = o + (size_t)(b * Hq + hq) * Tq * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int row = q0 + row_local + 8 * h;
    if (row >= Tq) continue;
    const float lsafe = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col < DV)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * DV + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * h] / lsafe,
                                  oacc[4 * j + 2 * h + 1] / lsafe);
    }
  }
}

// ---------------------------------------------------------------------------
// decode attention (one query row per sequence): one launch, the splits of
// a (batch, KV head) merged through a thread-block cluster's shared memory
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecHeads = 8;           // query heads a block holds
constexpr int kDecMaxSplit = 8;        // cluster size (the portable most)
constexpr int kDecRingBytes = 196608;  // most shared memory the ring takes

__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// A lane owns N floats of a cache row (one 16-byte chunk, N = 4, up to D =
// 128; two, N = 8, above, so that a row of D = 192 fits a warp); LPR lanes
// hold a row (LIVE of them N columns of K each: D = 80 has 20 live lanes of
// 32, the shuffle reductions needing a power of two; LIVEV of them N columns
// of V, Dv = 64 under D = 96 16 of 24), a warp RPW rows at once, and the
// block's GROUPS row groups take RPG rows each of a TILE-row tile.  NS ring
// stages of one K and one V tile, in the input dtype.
template <int D, int DV> struct Dec {
  static constexpr int N = D / 4 <= 32 ? 4 : 8;   // floats a lane
  static constexpr int LIVE = D / N, LIVEV = DV / N;
  static constexpr int LPR = pow2_ceil(LIVE);
  static constexpr int RPW = 32 / LPR;
  static constexpr int GROUPS = kDecWarps * RPW;
  static constexpr int TILE = GROUPS > 64 ? GROUPS : 64;
  static constexpr int RPG = TILE / GROUPS;
  static constexpr int ROWK = D * 4, ROWV = DV * 4;     // bytes a row
  static constexpr int STAGE = TILE * (ROWK + ROWV);
  static constexpr int NS = kDecRingBytes / STAGE < 4 ? kDecRingBytes / STAGE
                                                      : 4;
  static constexpr int RING = NS * STAGE;
  // after the loop the ring holds the warps' (m, l, acc) per head
  static constexpr int WARPS = kDecWarps * kDecHeads * (DV + 2) * 4;
  static constexpr int SCRATCH = RING > WARPS ? RING : WARPS;
  // the block's merged (m, l, acc) per head, read by the whole cluster
  static constexpr int PART = kDecHeads * (DV + 2) * 4;
  static constexpr int bytes = SCRATCH + PART;
  static_assert(LPR >= 1 && LPR <= 32 && NS >= 2 && D % N == 0 &&
                DV % N == 0 && LIVEV <= LIVE, "decode tile shape");
};

// N floats from 16-byte aligned p
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int e = 0; e < N; e += 4) Vec<float>::load(p + e, out + e);
}

// The end of both decode kernels.  Each of the block's NT / 32 warps has
// left its state per head in shared memory: max wm[w][h], sum wl[w][h],
// accumulator wacc[w][h][D] (kDecHeads slots a warp).  The block merges them
// into part = (max[8], sum[8], acc[8][D]); then, after a cluster barrier,
// each block merges a share of the (head, column) outputs from every
// block's part through distributed shared memory and writes out[h][d].
// Every block of the cluster, dead splits too, reaches both barriers: the
// first publishes the parts, the second keeps each block's shared memory
// alive until the others have read it.
template <typename T, int D, int NT>
__device__ __forceinline__ void decode_merge(const float* wm, const float* wl,
                                             const float* wacc, float* part,
                                             T* __restrict__ out, int ng) {
  constexpr int NW = NT / 32, H8 = kDecHeads;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  float* pm = part;                    // [head]: the block's max
  float* pl = pm + H8;                 // [head]: its sum
  float* pacc = pl + H8;               // [head][D]: its accumulator
  for (int e = tid; e < ng * D; e += NT) {
    const int h = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * H8 + h]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = exp2f(wm[w * H8 + h] - mx);
      a = fmaf(wacc[(w * H8 + h) * D + d], sc, a);
      ls = fmaf(wl[w * H8 + h], sc, ls);
    }
    pacc[h * D + d] = a;
    if (d == 0) {
      pm[h] = mx;
      pl[h] = ls;
    }
  }
  cluster.sync();
  for (int e = split * NT + tid; e < ng * D; e += nsplit * NT) {
    const int h = e / D, d = e % D;
    // every block's three values first, all loads in flight together
    float rm[kDecMaxSplit], rl[kDecMaxSplit], ra[kDecMaxSplit];
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r) {
      if (r < nsplit) {
        const float* rp = cluster.map_shared_rank(part, r);
        rm[r] = rp[h];
        rl[r] = rp[H8 + h];
        ra[r] = rp[2 * H8 + h * D + d];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r)
      if (r < nsplit) mx = fmaxf(mx, rm[r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r) {
      if (r < nsplit) {
        const float sc = exp2f(rm[r] - mx);
        ls = fmaf(rl[r], sc, ls);
        a = fmaf(ra[r], sc, a);
      }
    }
    store(out + h * D + d, ls > 0.f ? a / ls : 0.f);
  }
  cluster.sync();
}

// The live cache rows [lo, len) of a sequence whose query sits at position
// lengths[b] - 1: len clamped to [0, S]; with a window (> 0), lo = lengths[b]
// - window (the reference's kpos > qpos - window), taken from the unclamped
// length, in [0, len].
__device__ __forceinline__ void live_rows(int length, int S, int window,
                                          int& len, int& lo) {
  len = min(max(length, 0), S);
  lo = window > 0 ? (int)min(max((long long)length - window, 0LL),
                             (long long)len)
                  : 0;
}

// grid (nsplit, Hk * hgroups, B), cluster (nsplit, 1, 1): block `split` of
// the cluster reads its share of the first lengths[b] cache rows of KV head
// hk for up to kDecHeads query heads; the cluster's blocks then merge their
// softmax states through distributed shared memory and write out[b, h].
template <int D, int DV>
__global__ void __launch_bounds__(kDecThreads, 1)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths, float* __restrict__ o,
                        int Hq, int Hk, int S, int window, int hgroups,
                        float qscale) {
  using C = Dec<D, DV>;
  constexpr int N = C::N, H8 = kDecHeads;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const uint32_t ring = smem_u32(dec_smem);
  float* part = reinterpret_cast<float*>(dec_smem + C::SCRATCH);

  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int hk = blockIdx.y / hgroups, hg = blockIdx.y % hgroups;
  const int b = blockIdx.z;
  const int G = Hq / Hk;
  const int h0 = hk * G + hg * H8;                 // the block's first head
  const int ng = min(H8, G - hg * H8);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp * C::RPW + lane / C::LPR, sub = lane % C::LPR;
  const bool lane_live = sub < C::LIVE;     // the lane holds N columns of K
  const bool lane_livev = sub < C::LIVEV;   // ... and of V

  // the split: a share of whole tiles of the live rows [lo, len)
  int len, lo;
  live_rows(lengths[b], S, window, len, lo);
  const int t0 = lo / C::TILE;
  const int tiles = len > lo ? (len + C::TILE - 1) / C::TILE - t0 : 0;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int k0 = (t0 + split * per) * C::TILE;
  const int k1 = min(k0 + per * C::TILE, len);
  const int ntiles = k0 < k1 ? (k1 - k0 + C::TILE - 1) / C::TILE : 0;
  const float* kb = k + ((size_t)b * Hk + hk) * S * D;
  const float* vb = v + ((size_t)b * Hk + hk) * S * DV;

  // the live rows of tile i of K and V into ring stage i % NS
  auto load_tile = [&](int i) {
    constexpr int CPK = C::ROWK / 16, CPV = C::ROWV / 16;
    const int r0 = k0 + i * C::TILE, nk = min(C::TILE, k1 - r0);
    const uint32_t st = ring + (i % C::NS) * C::STAGE;
    for (int c = tid; c < nk * CPK; c += kDecThreads)
      cp_async16(st + c * 16, kb + (size_t)(r0 + c / CPK) * D + (c % CPK) * 4,
                 16);
    for (int c = tid; c < nk * CPV; c += kDecThreads)
      cp_async16(st + C::TILE * C::ROWK + c * 16,
                 vb + (size_t)(r0 + c / CPV) * DV + (c % CPV) * 4, 16);
  };
  for (int i = 0; i < C::NS - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // this lane's slice of the heads' query rows, float, scaled
  float qr[H8][N];
#pragma unroll
  for (int h = 0; h < H8; ++h) {
    if (h < ng && lane_live) {
      load_f32<N>(q + ((size_t)b * Hq + h0 + h) * D + sub * N, qr[h]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) qr[h][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) qr[h][e] *= qscale;
  }

  // the row group's running max, sum and accumulator slice per head
  float m[H8], l[H8], acc[H8][N];
#pragma unroll
  for (int h = 0; h < H8; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[h][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<C::NS - 2>();        // tile it landed (this thread's part)
    __syncthreads();                   // ... everyone's; stage it-1 is free
    if (it + C::NS - 1 < ntiles) load_tile(it + C::NS - 1);
    cp_async_commit();
    const uint8_t* ks = dec_smem + (it % C::NS) * C::STAGE;
    const uint8_t* vs = ks + C::TILE * C::ROWK;
    // the tile's live rows: [nlo, nk) (rows below the window's start too)
    const int nk = min(C::TILE, k1 - (k0 + it * C::TILE));
    const int nlo = max(lo - (k0 + it * C::TILE), 0);

    float s[C::RPG][H8];
#pragma unroll
    for (int i = 0; i < C::RPG; ++i) {
      float kf[N] = {};
      if (lane_live)
        load_f32<N>(reinterpret_cast<const float*>(
                    ks + (grp + i * C::GROUPS) * C::ROWK + sub * N * 4), kf);
#pragma unroll
      for (int h = 0; h < H8; ++h) {
        float a = 0.f;
        if (h < ng) {
#pragma unroll
          for (int e = 0; e < N; ++e) a = fmaf(qr[h][e], kf[e], a);
        }
        s[i][h] = a;
      }
    }
#pragma unroll
    for (int off = C::LPR / 2; off; off >>= 1)
#pragma unroll
      for (int i = 0; i < C::RPG; ++i)
#pragma unroll
        for (int h = 0; h < H8; ++h)
          if (h < ng) s[i][h] += __shfl_xor_sync(kFull, s[i][h], off);

#pragma unroll
    for (int h = 0; h < H8; ++h) {
      if (h >= ng) continue;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < C::RPG; ++i)
        if (grp + i * C::GROUPS < nk && grp + i * C::GROUPS >= nlo)
          mx = fmaxf(mx, s[i][h]);
      const float m_new = fmaxf(m[h], mx);
      if (m_new > m[h]) {              // rescale only when the max moved
        const float alpha = fast_exp2(m[h] - m_new);
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[h][e] *= alpha;
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < C::RPG; ++i) {
        const int r = grp + i * C::GROUPS;
        const float p = r < nk && r >= nlo ? fast_exp2(s[i][h] - m_new) : 0.f;
        s[i][h] = p;
        l[h] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < C::RPG; ++i) {
      const int r = grp + i * C::GROUPS;
      if (r >= nk || r < nlo) continue;  // stale shared memory: never read
      float vf[N] = {};
      if (lane_livev)
        load_f32<N>(
            reinterpret_cast<const float*>(vs + r * C::ROWV + sub * N * 4), vf);
#pragma unroll
      for (int h = 0; h < H8; ++h) {
        if (h >= ng) continue;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[h][e] = fmaf(s[i][h], vf[e], acc[h][e]);
      }
    }
  }

  // merge the warp's row groups (lanes sub, sub + LPR, ...): states
  // (m1, l1, a1) and (m2, l2, a2) merge to M = max, l1 e^(m1-M) + l2 e^(m2-M)
#pragma unroll
  for (int off = C::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < H8; ++h) {
      if (h >= ng) continue;
      const float mo = __shfl_xor_sync(kFull, m[h], off);
      const float mn = fmaxf(m[h], mo);
      const float sa = exp2f(m[h] - mn), sb = exp2f(mo - mn);
      l[h] = l[h] * sa + __shfl_xor_sync(kFull, l[h], off) * sb;
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[h][e] = acc[h][e] * sa + __shfl_xor_sync(kFull, acc[h][e], off) * sb;
      m[h] = mn;
    }
  }

  // then the block's warps, through the ring's shared memory
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(dec_smem);     // [warp][head]
  float* wl = wm + kDecWarps * H8;                    // [warp][head]
  float* wacc = wl + kDecWarps * H8;                  // [warp][head][DV]
  if (lane < C::LPR && lane_livev) {
#pragma unroll
    for (int h = 0; h < H8; ++h) {
      if (h >= ng) continue;
      if (sub == 0) {
        wm[warp * H8 + h] = m[h];
        wl[warp * H8 + h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < N; ++e)
        wacc[(warp * H8 + h) * DV + sub * N + e] = acc[h][e];
    }
  }
  __syncthreads();
  decode_merge<float, DV, kDecThreads>(wm, wl, wacc, part,
                                       o + ((size_t)b * Hq + h0) * DV, ng);
}

template <int D, int DV>
int flash_f32_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hk, int Tq, int Tk, int causal,
                     int has_window, int window, int q_offset, float qscale,
                     cudaStream_t stream) {
  const int bytes = FlashSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kTile - 1) / kTile, Hq, B);
  flash_attention_kernel<D, DV><<<grid, kFlashThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Hq, Hk,
      Tq, Tk, causal, has_window, window, q_offset, qscale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hk, int Tq, int Tk, int causal,
                       int has_window, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  const int bytes = WgSmem<D, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Tq + kWgBM - 1) / kWgBM;
  if (nq > 65535) return kBadShape;
  const dim3 grid(Hq * B, nq);       // all heads' latest query tiles first
  flash_attention_wgmma_kernel<D, DV><<<grid, kWgThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hk, Tq, Tk, causal,
      has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// bfloat16: the same split, ring and merges, with both products on the
// tensor cores (mma.sync m16n8k16: the block's <= 8 query heads as the
// 16-row M, padded with zeros; wgmma's 64-row M would be 7/8 padding).  A
// block of 4 warps: warp w takes cache rows [16 w, 16 w + 16) of each
// 64-row tile.  S = Q K^T with Q's fragments in registers (bf16 as given;
// the scale goes on the float32 scores) and K read by ldmatrix; the online
// softmax runs on S's fragment (head gid, rows 2 tig and 2 tig + 1 of each
// 8-row half) with each row max over the 4 lanes of a head; P, rounded to
// bf16, is the A fragment of O += P V as it lies, V read by ldmatrix.trans.
// The ring keeps K and V in bf16, chunk c of row r at c ^ swz(r) so that
// ldmatrix's eight rows hit eight bank groups; rows past the split are
// zero-filled (a zero V row times p = 0 stays 0).
constexpr int kDecMmaThreads = 128;

// A bf16 row of W columns in the ring: CPR 16-byte chunks, in whole groups
// of 8 once it has 8 or more, so that c ^ (r & 7) stays inside it (D = 80:
// 10 chunks in 16; D = 96: 12 in 16)
template <int W> struct MmaRow {
  static constexpr int CPR = W * 2 / 16;            // 16-byte chunks a row
  static constexpr int SCPR = CPR >= 8 ? (CPR + 7) / 8 * 8 : CPR;
  static constexpr int ROW = SCPR * 16;             // bytes a row
  // the swizzled byte offset of chunk c of row r
  __device__ static uint32_t at(int r, int c) {
    const int sw = SCPR >= 8 ? (r & 7) : SCPR == 4 ? ((r >> 1) & 3)
                                                   : ((r >> 2) & 1);
    return r * ROW + ((c ^ sw) << 4);
  }
};

template <int D, int DV> struct DecMma {
  static constexpr int TILE = 64;
  using RK = MmaRow<D>;                             // K rows
  using RV = MmaRow<DV>;                            // V rows
  static constexpr int STAGE = TILE * (RK::ROW + RV::ROW);
  static constexpr int NS = kDecRingBytes / STAGE < 6 ? kDecRingBytes / STAGE
                                                      : 6;
  static constexpr int RING = NS * STAGE;
  static constexpr int WARPS = (kDecMmaThreads / 32) * kDecHeads * (DV + 2) * 4;
  static constexpr int SCRATCH = RING > WARPS ? RING : WARPS;
  static constexpr int PART = kDecHeads * (DV + 2) * 4;
  static constexpr int bytes = SCRATCH + PART;
  static_assert(NS >= 2 && D % 16 == 0 && DV % 16 == 0, "decode tile shape");
};

template <int D, int DV>
__global__ void __launch_bounds__(kDecMmaThreads, 1)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ o, int Hq, int Hk,
                            int S, int window, int hgroups, float qscale) {
  using C = DecMma<D, DV>;
  using RK = typename C::RK;
  using RV = typename C::RV;
  constexpr int KS = D / 16, VS = DV / 16, H8 = kDecHeads, TILE = C::TILE;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const uint32_t ring = smem_u32(dec_smem);
  float* part = reinterpret_cast<float*>(dec_smem + C::SCRATCH);

  const int nsplit = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int hk = blockIdx.y / hgroups, hg = blockIdx.y % hgroups;
  const int b = blockIdx.z;
  const int G = Hq / Hk;
  const int h0 = hk * G + hg * H8;
  const int ng = min(H8, G - hg * H8);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  int len, lo;
  live_rows(lengths[b], S, window, len, lo);
  const int t0 = lo / TILE;
  const int tiles = len > lo ? (len + TILE - 1) / TILE - t0 : 0;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int k0 = (t0 + split * per) * TILE;
  const int k1 = min(k0 + per * TILE, len);
  const int ntiles = k0 < k1 ? (k1 - k0 + TILE - 1) / TILE : 0;
  const __nv_bfloat16* kb = k + ((size_t)b * Hk + hk) * S * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Hk + hk) * S * DV;

  // tile i of K and V into ring stage i % NS; rows past the split zeros
  auto load_tile = [&](int i) {
    const int r0 = k0 + i * TILE, nk = min(TILE, k1 - r0);
    const uint32_t st = ring + (i % C::NS) * C::STAGE;
    for (int c = tid; c < TILE * RK::CPR; c += kDecMmaThreads) {
      const int r = c / RK::CPR, cc = c % RK::CPR;
      const bool ok = r < nk;
      const size_t off = ok ? (size_t)(r0 + r) * D + cc * 8 : 0;
      cp_async16(st + RK::at(r, cc), kb + off, ok ? 16 : 0);
    }
    for (int c = tid; c < TILE * RV::CPR; c += kDecMmaThreads) {
      const int r = c / RV::CPR, cc = c % RV::CPR;
      const bool ok = r < nk;
      const size_t off = ok ? (size_t)(r0 + r) * DV + cc * 8 : 0;
      cp_async16(st + TILE * RK::ROW + RV::at(r, cc), vb + off, ok ? 16 : 0);
    }
  };
  for (int i = 0; i < C::NS - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // Q's A fragments: head gid (rows gid + 8 are zero), k-step kk
  uint32_t qa[KS][2];
  const __nv_bfloat16* qrow = q + ((size_t)b * Hq + h0 + gid) * D;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = gid < ng ? *reinterpret_cast<const uint32_t*>(
                               qrow + 16 * kk + 2 * tig) : 0u;
    qa[kk][1] = gid < ng ? *reinterpret_cast<const uint32_t*>(
                               qrow + 16 * kk + 8 + 2 * tig) : 0u;
  }

  // head gid's running max and (this lane's part of the) sum; O's
  // fragment: oacc[j][0..1] = O[gid][8 j + 2 tig, + 1]
  float m_run = kNegInf, l_run = 0.f;
  float oacc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  const int mrow = lane >> 3, rrow = lane & 7;     // ldmatrix lane roles
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<C::NS - 2>();
    __syncthreads();
    if (it + C::NS - 1 < ntiles) load_tile(it + C::NS - 1);
    cp_async_commit();
    const uint32_t ks = ring + (it % C::NS) * C::STAGE;
    const uint32_t vs = ks + TILE * RK::ROW;
    // the tile's live rows: [nlo, nk) (rows below the window's start too)
    const int nk = min(TILE, k1 - (k0 + it * TILE));
    const int nlo = max(lo - (k0 + it * TILE), 0);

    // S = Q K^T over the warp's 16 rows: two n-tiles of 8 rows
    float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + RK::at(16 * warp + (mrow >> 1) * 8 + rrow,
                                  2 * kk + (mrow & 1)));
      mma_16816(sacc[0], qa[kk][0], 0u, qa[kk][1], 0u, kf[0], kf[1]);
      mma_16816(sacc[1], qa[kk][0], 0u, qa[kk][1], 0u, kf[2], kf[3]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[nt][e] *= qscale;
        const int r = 16 * warp + 8 * nt + 2 * tig + e;
        if (r < nk && r >= nlo) mx = fmaxf(mx, sacc[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    if (m_new > m_run) {               // rescale only when the max moved
      const float alpha = fast_exp2(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[j][0] *= alpha;
        oacc[j][1] *= alpha;
      }
      m_run = m_new;
    }
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + 8 * nt + 2 * tig + e;
        p[nt][e] = r < nk && r >= nlo ? fast_exp2(sacc[nt][e] - m_new) : 0.f;
        l_run += p[nt][e];
      }
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);

    // O += P V: 16 columns of DV a step
#pragma unroll
    for (int c2 = 0; c2 < VS; ++c2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + RV::at(16 * warp + (mrow & 1) * 8 + rrow,
                                        2 * c2 + (mrow >> 1)));
      mma_16816(oacc[2 * c2], pa0, 0u, pa2, 0u, vf[0], vf[1]);
      mma_16816(oacc[2 * c2 + 1], pa0, 0u, pa2, 0u, vf[2], vf[3]);
    }
  }

  // the warp's state per head into shared memory, then the merges
  l_run += __shfl_xor_sync(kFull, l_run, 1);
  l_run += __shfl_xor_sync(kFull, l_run, 2);
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(dec_smem);
  float* wl = wm + (kDecMmaThreads / 32) * H8;
  float* wacc = wl + (kDecMmaThreads / 32) * H8;
  if (gid < ng) {
    if (tig == 0) {
      wm[warp * H8 + gid] = m_run;
      wl[warp * H8 + gid] = l_run;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      wacc[(warp * H8 + gid) * DV + 8 * j + 2 * tig] = oacc[j][0];
      wacc[(warp * H8 + gid) * DV + 8 * j + 2 * tig + 1] = oacc[j][1];
    }
  }
  __syncthreads();
  decode_merge<__nv_bfloat16, DV, kDecMmaThreads>(
      wm, wl, wacc, part, o + ((size_t)b * Hq + h0) * DV, ng);
}

// the kernel of a dtype: bf16 on the tensor cores, float32 on the CUDA cores
template <typename T, int D, int DV> struct DecodeKernel {
  static constexpr int threads = kDecThreads, bytes = Dec<D, DV>::bytes;
  static auto fn() { return decode_attention_kernel<D, DV>; }
};
template <int D, int DV> struct DecodeKernel<__nv_bfloat16, D, DV> {
  static constexpr int threads = kDecMmaThreads;
  static constexpr int bytes = DecMma<D, DV>::bytes;
  static auto fn() { return decode_attention_mma_kernel<D, DV>; }
};

template <typename T, int D, int DV>
int decode_launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, int B, int Hq, int Hk, int S,
                  int nsplit, int window, float qscale, cudaStream_t stream) {
  using K = DecodeKernel<T, D, DV>;
  const int hgroups = (Hq / Hk + kDecHeads - 1) / kDecHeads;
  if (nsplit < 1 || nsplit > kDecMaxSplit || B > 65535 ||
      (long long)Hk * hgroups > 65535)
    return kBadShape;
  // the function's attributes, once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(K::fn(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) ready |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, Hk * hgroups, B);
  cfg.blockDim = dim3(K::threads);
  cfg.dynamicSmemBytes = K::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, K::fn(), (const T*)q, (const T*)k,
                           (const T*)v, (const int*)lengths, (T*)o, Hq, Hk,
                           S, window, hgroups, qscale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the (D, Dv) pairs the launchers take, as one switch value
#define PAIR(d, dv) ((d) * 1024 + (dv))

// out = attention(q, k, v) with causal / sliding-window masks; query row i
// at absolute position q_offset + i; q and k of head dim D, v and out of Dv.
// dtype 0: float32, 1: bfloat16.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hk, int Tq, int Tk,
                           int D, int Dv, int dtype, int causal,
                           int has_window, int window, int q_offset,
                           float qscale, void* stream) {
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH(L, DD, DDV)                                                  \
  return L<DD, DDV>(q, k, v, o, B, Hq, Hk, Tq, Tk, causal, has_window,     \
                    window, q_offset, qscale, s)
#define FLASH_D(L)                              \
  switch (PAIR(D, Dv)) {                        \
    case PAIR(16, 16): FLASH(L, 16, 16);        \
    case PAIR(32, 32): FLASH(L, 32, 32);        \
    case PAIR(64, 64): FLASH(L, 64, 64);        \
    case PAIR(80, 80): FLASH(L, 80, 80);        \
    case PAIR(128, 128): FLASH(L, 128, 128);    \
    case PAIR(96, 64): FLASH(L, 96, 64);        \
    case PAIR(192, 128): FLASH(L, 192, 128);    \
    default: return kBadShape;                  \
  }
  if (dtype == 0) FLASH_D(flash_f32_launch)
  FLASH_D(flash_wgmma_launch)
#undef FLASH_D
#undef FLASH
}

// out[b, h] = attention of q[b, h] over the cache rows [lo, min(lengths[b],
// S)), lo = max(0, lengths[b] - window) with a window (> 0), else 0, in one
// launch: nsplit (1..8) blocks of a cluster per (batch, KV head, group of 8
// query heads); q and k of head dim D, v and out of Dv.  dtype 0: float32,
// 1: bfloat16.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int B, int Hq,
                            int Hk, int S, int D, int Dv, int dtype,
                            int nsplit, int window, float qscale,
                            void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (Hk < 1 || Hq % Hk) return kBadShape;
  cudaStream_t s = (cudaStream_t)stream;
#define DEC(T, DD, DDV)                                                   \
  return decode_launch<T, DD, DDV>(q, k, v, lengths, o, B, Hq, Hk, S,     \
                                   nsplit, window, qscale, s)
#define DEC_D(T)                                \
  switch (PAIR(D, Dv)) {                        \
    case PAIR(16, 16): DEC(T, 16, 16);          \
    case PAIR(32, 32): DEC(T, 32, 32);          \
    case PAIR(64, 64): DEC(T, 64, 64);          \
    case PAIR(80, 80): DEC(T, 80, 80);          \
    case PAIR(128, 128): DEC(T, 128, 128);      \
    case PAIR(96, 64): DEC(T, 96, 64);          \
    case PAIR(192, 128): DEC(T, 192, 128);      \
    default: return kBadShape;                  \
  }
  if (dtype == 0) DEC_D(float)
  DEC_D(__nv_bfloat16)
#undef DEC_D
#undef DEC
}

#undef PAIR

}  // extern "C"
