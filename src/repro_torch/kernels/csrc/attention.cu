// Attention kernels for Hopper (sm_90a): the GQA flash-attention forward
// (prefill) and GQA decode attention (one query token against a KV cache).
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
// softmax arithmetic is float32, in base 2: q is scaled by log2(e)/sqrt(D)
// once, and exp2 takes the place of exp (the same function).  P stays
// float32 in P.V (the reference does not round it either).
//
// flash_attention_kernel.  Bound at the prefill's shapes (B=4, Hq=12,
// Tq=2048 over a 2112-row cache, D=128): 4·D operations per live
// (query, key) pair, 5.2e10 per layer, against ~59 MB of q, k, v and out:
// operations bound it.  The TPU walked KV blocks along a sequential grid
// axis with the statistics in VMEM; here one block of 256 threads owns one
// (batch, query head, 64-row query tile) and loops over 64-row KV tiles
// itself, its statistics in registers.  Each thread holds a 4 x 4 block of
// the score tile and the same 4 rows of the output (4 x D/16 floats), so
// row max and row sum reduce over the 16 lanes of a half-warp with
// shuffles.  Tiles past the causal edge, before the window or past Tk are
// never loaded: the prefill attends over the whole cache (Tk = max_len),
// and the rows past the prompt cost nothing.  Masked entries are selected
// out (not left to exp underflow); a row with no live key writes zeros.
// Q, K/V and P tiles are float32 in shared memory (row stride D + 4 floats:
// 16-byte aligned, and eight threads reading eight rows' float4s hit 32
// distinct banks); K and V take turns in one buffer, which keeps two
// blocks on an SM at D = 128.  The products run on the CUDA cores in
// float32; tensor cores (mma / wgmma on bf16 tiles) are later work.
// Query tiles are issued latest first, since they have the most KV tiles.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;            // query and KV tile rows
constexpr int kFlashThreads = 256;
constexpr int kDecThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hk, int Tq, int Tk, int causal, int has_window,
                       int window, int q_offset, float qscale) {
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
  const T* qb = q + (size_t)(b * Hq + hq) * Tq * D;
  const T* kb = k + (size_t)(b * Hk + hk) * Tk * D;
  const T* vb = v + (size_t)(b * Hk + hk) * Tk * D;
  T* ob = o + (size_t)(b * Hq + hq) * Tq * D;

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

  load_rows<T, D, LD>(Qs, qb, q0, kTile, Tq, qscale, tid, kFlashThreads);

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
    load_rows<T, D, LD>(KVs, kb, k0, kTile, Tk, 1.f, tid, kFlashThreads);
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
    load_rows<T, D, LD>(KVs, vb, k0, kTile, Tk, 1.f, tid, kFlashThreads);
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

template <typename T, int D>
int flash_launch(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hk, int Tq, int Tk, int causal, int has_window,
                 int window, int q_offset, float qscale, cudaStream_t stream) {
  const int bytes = FlashSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kTile - 1) / kTile, Hq, B);
  flash_attention_kernel<T, D><<<grid, kFlashThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hk, Tq, Tk, causal,
      has_window, window, q_offset, qscale);
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

constexpr int kBadShape = -1;

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
#define FLASH(T, DD)                                                       \
  return flash_launch<T, DD>(q, k, v, o, B, Hq, Hk, Tq, Tk, causal,        \
                             has_window, window, q_offset, qscale, s)
#define FLASH_D(T)            \
  switch (D) {                \
    case 16: FLASH(T, 16);    \
    case 32: FLASH(T, 32);    \
    case 64: FLASH(T, 64);    \
    case 128: FLASH(T, 128);  \
    default: return kBadShape; \
  }
  if (dtype == 0) FLASH_D(float)
  FLASH_D(__nv_bfloat16)
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
