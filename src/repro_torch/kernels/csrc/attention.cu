// Attention kernels for Hopper (sm_90a): the GQA flash-attention forward
// (prefill; bf16 on the tensor cores, float32 on the CUDA cores) and GQA
// decode attention (one query token against a KV cache).
//
// Replaces the TPU kernels
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_pallas
//     (_flash_kernel: online softmax over a sequential KV grid axis, the
//      f32 max / denominator / accumulator in VMEM scratch, causal and
//      sliding-window masks, dead KV blocks skipped with pl.when)
//   src/repro/kernels/decode_attention/kernel.py  decode_attention_pallas
//     (_decode_kernel: one query row per (batch, query head), the cache
//      swept block by block along a sequential grid axis, blocks at or past
//      lengths[b] skipped)
//
// Layouts are the reference's: q [B, Hq, Tq, D], k and v [B, Hk, Tk, D],
// out [B, Hq, Tq, D], contiguous, in float32 or bfloat16.  Query head h
// reads KV head h / (Hq / Hk): K and V are never repeated in memory.  All
// softmax arithmetic is float32, in base 2 (exp2 of scores times
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
// at D = 128.  P stays float32 in P.V.
//
// decode_attention_kernel + decode_combine_kernel.  Bound: reading the K
// and V rows below lengths[b] once (8.5 MB per layer at B=4, Hk=2, D=128,
// length 2080: 2.5 us at 3.35 TB/s); the arithmetic is ~1 operation per
// byte.  One block per (batch, KV head, split of the cache) serves all
// Hq/Hk query heads of that KV head, so each cache row is read once.  A
// single block per (batch, KV head) would put 8 blocks on 132 SMs at
// B=4, so the wrapper cuts the cache into splits (about two blocks per
// SM); each block stages 64-row K/V tiles in shared memory, keeps per-head
// running max / sum / accumulator over its split, and writes them as a
// partial.  The combine kernel merges a row's partials (splits with no
// live key carry l = 0 and are left out; a row with none writes zeros).
// Splits that start at or past lengths[b] return at once.

#include <cuda_bf16.h>
#include <math_constants.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;            // query and KV tile rows
constexpr int kFlashThreads = 256;
constexpr int kDecThreads = 128;
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
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
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

template <int D> struct FlashSmem {
  static constexpr int LD = D + 4;               // Q and K/V row stride
  static constexpr int LP = kTile + 4;           // P row stride
  static constexpr int floats = 2 * kTile * LD + kTile * LP;
  static constexpr int bytes = floats * 4;
};

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Hq, int Hk, int Tq, int Tk, int causal,
                       int has_window, int window, int q_offset,
                       float qscale) {
  constexpr int LD = FlashSmem<D>::LD, LP = FlashSmem<D>::LP;
  constexpr int NC = D / 16;                     // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [kTile][LD], scaled
  float* KVs = Qs + kTile * LD;                  // [kTile][LD], K then V
  float* Ps = KVs + kTile * LD;                  // [kTile][LP]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hk);
  const float* qb = q + (size_t)(b * Hq + hq) * Tq * D;
  const float* kb = k + (size_t)(b * Hk + hk) * Tk * D;
  const float* vb = v + (size_t)(b * Hk + hk) * Tk * D;
  float* ob = o + (size_t)(b * Hq + hq) * Tq * D;

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
    load_rows<float, D, LD>(KVs, kb, k0, kTile, Tk, 1.f, tid, kFlashThreads);
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
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
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
    load_rows<float, D, LD>(KVs, vb, k0, kTile, Tk, 1.f, tid, kFlashThreads);
    __syncthreads();                     // V and P visible

#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = KVs + (c + cc) * LD;
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
      store(ob + (size_t)row * D + col(n), acc[i][n] / lsafe);
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
// (c ^ r % 8) * 16.  Head dims below 64 are zero-padded to 64 columns.
template <int D> struct WgSmem {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int Q = (DP / 64) * kWgBM * 128;     // bytes of Q
  static constexpr int KV = (DP / 64) * kWgBN * 128;    // one K or V tile
  static constexpr int bars = Q + 4 * KV;               // 8 mbarriers
  static constexpr int bytes = bars + 64 + 1024;        // + 1024 alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's generic-proxy shared writes visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma issue / wait
template <int N> __device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading byte offset (MN-major: the next 64-column block), stride
// byte offset 1024 (the next 8 rows), layout type 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}
// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (+)= A[smem] * B[smem]^T, m64n128k16, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A[registers] * B[smem], m64n64k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A[registers] * B[smem], m64n128k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// rows [row0, row0 + ROWS) of a row-major [*, D] bf16 matrix into dst in the
// swizzled layout of WgSmem (column block c / 8 at c / 8 * ROWS * 128
// bytes); rows at or past `limit` and the padding columns are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int limit, int tid) {
  constexpr int CPR = WgSmem<D>::DP / 8;           // 16-byte chunks a row
#pragma unroll 8
  for (int it = 0; it < ROWS * CPR / kWgProducers; ++it) {
    const int i = tid + it * kWgProducers;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < limit && c * 8 < D;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * D + c * 8 : src;
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

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int Hq, int Hk,
                             int Tq, int Tk, int causal, int has_window,
                             int window, int q_offset, float scale) {
  using S = WgSmem<D>;
  constexpr int DP = S::DP;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t sQ = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sK = sQ + S::Q;                 // 2 stages of K
  const uint32_t sV = sK + 2 * S::KV;            // 2 stages of V
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
  const __nv_bfloat16* vb = v + (size_t)(b * Hk + hk) * Tk * D;

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
      load_tile_sw128<D, kWgBN>(sK + st * S::KV, kb, k0, Tk, ptid);
      cp_async_commit();
      if (it > 0) {
        cp_async_wait<1>();            // V of the previous tile landed
        fence_proxy_async();
        __syncwarp();
        if (ptid % 32 == 0) mbar_arrive(fullv + 8 * (st ^ 1));
      }
      if (round > 0) mbar_wait(emptyv + 8 * st, (round - 1) & 1);
      load_tile_sw128<D, kWgBN>(sV + st * S::KV, vb, k0, Tk, ptid);
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

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p[kWgBN / 4];               // P in bf16 pairs: A fragments of P V

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, round = it >> 1;
    const int k0 = (kt_begin + it) * kWgBN;
    const uint32_t ks = sK + st * S::KV, vs = sV + st * S::KV;

    // S = Q K^T, [64 rows, kWgBN keys] in f32 registers
    float s[kWgBN / 2];
    mbar_wait(fullk + 8 * st, round & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
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
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V, V [kWgBN keys, DP] the MN-major B operand
    mbar_wait(fullv + 8 * st, round & 1);
    reg_fence<DP / 2>(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 128, kWgBN * 128);
      if constexpr (DP == 64) wgmma_rs_n64(oacc, &p[4 * kk], dv);
      else wgmma_rs_n128(oacc, &p[4 * kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DP / 2>(oacc);
    mbar_arrive(emptyv + 8 * st);
  }

  __nv_bfloat16* ob = o + (size_t)(b * Hq + hq) * Tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int row = q0 + row_local + 8 * h;
    if (row >= Tq) continue;
    const float lsafe = lt == 0.f ? 1.f : lt;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * h] / lsafe,
                                  oacc[4 * j + 2 * h + 1] / lsafe);
    }
  }
}

// ---------------------------------------------------------------------------
// decode attention (one query row per sequence)
// ---------------------------------------------------------------------------

template <int D> struct DecodeSmem {
  static constexpr int LD = D + 4;
  static int floats(int G) {
    return 2 * G * D + 2 * kTile * LD + G * kTile + 3 * G;
  }
};

// partials: ml [B, Hq, nsplit, 2] (running max, sum), acc [B, Hq, nsplit, D]
template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int Hq, int Hk, int S,
                        int nsplit, int chunk, float qscale) {
  constexpr int LD = DecodeSmem<D>::LD;
  const int G = Hq / Hk;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [G][D], scaled
  float* Acc = Qs + G * D;             // [G][D]
  float* Ks = Acc + G * D;             // [kTile][LD]
  float* Vs = Ks + kTile * LD;         // [kTile][LD]
  float* Ss = Vs + kTile * LD;         // [G][kTile]
  float* Ms = Ss + G * kTile;          // [G]
  float* Ls = Ms + G;                  // [G]
  float* Al = Ls + G;                  // [G]

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(lengths[b], 0), S);
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const size_t row0 = (size_t)b * Hq + (size_t)hk * G;   // first q row
  const size_t part0 = row0 * nsplit + split;            // its partial

  if (k0 >= k1) {                      // dead split: no live key
    for (int h = tid; h < G; h += kDecThreads) {
      part_ml[(part0 + (size_t)h * nsplit) * 2] = kNegInf;
      part_ml[(part0 + (size_t)h * nsplit) * 2 + 1] = 0.f;
    }
    return;
  }

  load_rows<T, D, D>(Qs, q + row0 * D, 0, G, G, qscale, tid, kDecThreads);
  for (int e = tid; e < G * D; e += kDecThreads) Acc[e] = 0.f;
  for (int h = tid; h < G; h += kDecThreads) {
    Ms[h] = kNegInf;
    Ls[h] = 0.f;
  }
  const T* kb = k + ((size_t)b * Hk + hk) * S * D;
  const T* vb = v + ((size_t)b * Hk + hk) * S * D;

  for (int t0 = k0; t0 < k1; t0 += kTile) {
    const int nk = min(kTile, k1 - t0);
    __syncthreads();
    load_rows<T, D, LD>(Ks, kb, t0, nk, k1, 1.f, tid, kDecThreads);
    load_rows<T, D, LD>(Vs, vb, t0, nk, k1, 1.f, tid, kDecThreads);
    __syncthreads();
    for (int p = tid; p < G * kTile; p += kDecThreads) {
      const int h = p / kTile, j = p % kTile;
      if (j >= nk) continue;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4)
        s = dot4(*reinterpret_cast<const float4*>(Qs + h * D + d),
                 *reinterpret_cast<const float4*>(Ks + j * LD + d), s);
      Ss[h * kTile + j] = s;
    }
    __syncthreads();
    for (int h = warp; h < G; h += kDecThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, Ss[h * kTile + j]);
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(Ms[h], mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = exp2f(Ss[h * kTile + j] - m_new);
        Ss[h * kTile + j] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(Ms[h] - m_new);
        Al[h] = alpha;
        Ls[h] = Ls[h] * alpha + sum;
        Ms[h] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kDecThreads) {
      const int h = e / D, d = e % D;
      float a = Acc[e] * Al[h];
      const float* p = Ss + h * kTile;
      for (int j = 0; j < nk; ++j) a = fmaf(p[j], Vs[j * LD + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kDecThreads) {
    const int h = e / D, d = e % D;
    part_acc[(part0 + (size_t)h * nsplit) * D + d] = Acc[e];
  }
  for (int h = tid; h < G; h += kDecThreads) {
    part_ml[(part0 + (size_t)h * nsplit) * 2] = Ms[h];
    part_ml[(part0 + (size_t)h * nsplit) * 2 + 1] = Ls[h];
  }
}

// one block per query row (b, hq), one thread per output column
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, int nsplit, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    if (ml[2 * s + 1] > 0.f) {
      const float w = exp2f(ml[2 * s] - mx);
      l = fmaf(ml[2 * s + 1], w, l);
      a = fmaf(part_acc[(row * nsplit + s) * D + d], w, a);
    }
  }
  store(o + row * D + d, l > 0.f ? a / l : 0.f);
}

template <int D>
int flash_f32_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hk, int Tq, int Tk, int causal,
                     int has_window, int window, int q_offset, float qscale,
                     cudaStream_t stream) {
  const int bytes = FlashSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kTile - 1) / kTile, Hq, B);
  flash_attention_kernel<D><<<grid, kFlashThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Hq, Hk,
      Tq, Tk, causal, has_window, window, q_offset, qscale);
  return (int)cudaGetLastError();
}

template <int D>
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hk, int Tq, int Tk, int causal,
                       int has_window, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  const int bytes = WgSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Tq + kWgBM - 1) / kWgBM;
  if (nq > 65535) return kBadShape;
  const dim3 grid(Hq * B, nq);       // all heads' latest query tiles first
  flash_attention_wgmma_kernel<D><<<grid, kWgThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Hq, Hk, Tq, Tk, causal,
      has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int decode_launch(const void* q, const void* k, const void* v,
                  const void* lengths, void* part_ml, void* part_acc, void* o,
                  int B, int Hq, int Hk, int S, int nsplit, int chunk,
                  float qscale, cudaStream_t stream) {
  const int bytes = DecodeSmem<D>::floats(Hq / Hk) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, Hk, B);
  decode_attention_kernel<T, D><<<grid, kDecThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths,
      (float*)part_ml, (float*)part_acc, Hq, Hk, S, nsplit, chunk, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<B * Hq, D, 0, stream>>>(
      (const float*)part_ml, (const float*)part_acc, (T*)o, nsplit, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = attention(q, k, v) with causal / sliding-window masks; query row i
// at absolute position q_offset + i.  dtype 0: float32, 1: bfloat16.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hk, int Tq, int Tk,
                           int D, int dtype, int causal, int has_window,
                           int window, int q_offset, float qscale,
                           void* stream) {
  if (B == 0 || Hq == 0 || Tq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH(L, DD)                                                       \
  return L<DD>(q, k, v, o, B, Hq, Hk, Tq, Tk, causal, has_window, window,  \
               q_offset, qscale, s)
#define FLASH_D(L)            \
  switch (D) {                \
    case 16: FLASH(L, 16);    \
    case 32: FLASH(L, 32);    \
    case 64: FLASH(L, 64);    \
    case 128: FLASH(L, 128);  \
    default: return kBadShape; \
  }
  if (dtype == 0) FLASH_D(flash_f32_launch)
  FLASH_D(flash_wgmma_launch)
#undef FLASH_D
#undef FLASH
}

// out[b, h] = attention of q[b, h] over the first lengths[b] cache rows;
// part_ml [B*Hq*nsplit*2] and part_acc [B*Hq*nsplit*D] float32 scratch.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* part_ml,
                            void* part_acc, void* o, int B, int Hq, int Hk,
                            int S, int D, int dtype, int nsplit, int chunk,
                            float qscale, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define DEC(T, DD)                                                          \
  return decode_launch<T, DD>(q, k, v, lengths, part_ml, part_acc, o, B,    \
                              Hq, Hk, S, nsplit, chunk, qscale, s)
#define DEC_D(T)             \
  switch (D) {               \
    case 16: DEC(T, 16);     \
    case 32: DEC(T, 32);     \
    case 64: DEC(T, 64);     \
    case 128: DEC(T, 128);   \
    default: return kBadShape; \
  }
  if (dtype == 0) DEC_D(float)
  DEC_D(__nv_bfloat16)
#undef DEC_D
#undef DEC
}

}  // extern "C"
