// Mamba-2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd/kernel.py  ssd_pallas
//     (_ssd_kernel: grid (B*H, T/L), the chunk axis innermost and
//      sequential, the [S, P] float32 state carried across chunks in VMEM
//      scratch; per chunk the masked-decay "attention" C B^T o Gamma o dt
//      times x, the carried state's contribution, and the state update)
// and adds what the reference's plain ssd_ref(init_state=...) gives the
// cached prefill: an optional initial state [B, H, S, P] float32 (zeros
// when absent, which is exactly ssd_pallas).
//
// Inputs: x [B, T, H, P] (float32 or bfloat16), dt [B, T, H] float32, A [H]
// float32, B and C [B, T, G, S] in x's dtype; head h reads group
// h / (H / G), and B and C are never repeated in memory.  x, B and C may be
// strided views (in the model they are slices of one [B, T, d_inner + 2GS]
// tensor): the launcher takes their batch, time and head/group strides in
// elements; the last dimension is contiguous.  Outputs: y [B, T, H, P] in
// x's dtype (contiguous) and the final state [B, H, S, P] float32.  All
// arithmetic is float32, as the TPU kernel's preferred_element_type.
//
// Per chunk of L rows (L <= 128; rows past T count as dt = 0, x = B = C = 0,
// which is the reference's padding: no decay and no update, so the final
// state is the state after row T - 1, and padded rows are never written):
//   la    = cumsum(dt * A)                                   [L]
//   y     = ((C B^T) o Gamma o dt) @ x + (C o exp(la)) @ S_in
//           Gamma[t, s] = exp(la_t - la_s) for s <= t, else 0 (selected out,
//           not left to exp: la_t - la_s > 0 above the diagonal)
//   S_out = exp(la_L) S_in + (B o dt o exp(la_L - la))^T @ x
//
// Design.  The TPU ran its chunk axis in order and carried the state in
// VMEM.  CUDA blocks run in parallel, and one block per (batch, head)
// looping over chunks would put 96 blocks on 132 SMs at the full width
// (B = 4, H = 24) with every chunk's work serialised behind the last.  So
// the carry becomes two passes around a scan, three launches in all:
//   1. ssd_chunk_state_kernel, one block per (chunk, head, batch): the
//      chunk's own state (B o w)^T @ x with w = dt o exp(la_L - la), and its
//      decay exp(la_L), into float32 scratch [B, H, nl, S, P] and [B, H, nl];
//   2. ssd_state_scan_kernel, one thread per (batch, head, state element):
//      walks the nl chunks in order, replacing each chunk's own state by the
//      state entering it, and writes the final state (from init_state or 0);
//      it moves the scratch twice (200 MB at the full width) and keeps 8
//      chunks' loads in flight a thread;
//   3. ssd_output_kernel, one block per (chunk, 64-row slice of it, head,
//      batch): y = exp(la_t) (C_t . S_in) + sum over s <= t of
//      (C_t . B_s) exp(la_t - la_s) dt_s x_s, in 64 x 64 score tiles, only
//      the tiles on or below the diagonal.
// At the full width that is 3072 blocks for each of passes 1 and 3 (6144 in
// 3).  Shared memory at S = 128, P = 64, where a chunk's float32 operands
// would take 256 KB: pass 3 keeps C's 64 rows (34.8 KB) and, in turn, the
// entering state (34.8 KB) or one 64-row tile of B, x and the masked scores
// (69.6 KB): 105 KB, two blocks an SM; pass 1 holds 64-row tiles of B o w
// and x (52 KB).  All products run on the CUDA cores in float32, each
// thread accumulating a register tile (8 x 4 in pass 1, 4 x 4 in pass 3);
// bf16 tensor-core tiles (mma / wgmma) are later work.  Bound at the full
// width (T = 4096, bf16): 3.2e10 operations, 0.033 ms at the bf16
// tensor-core peak, against ~0.11 GB of x, y, B, C, dt and the state:
// bytes and operations bound it about equally.  On G = 1 all heads read
// the same B and C, so C B^T is the same for every head of a (batch,
// chunk); computing it once is later work too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kTile = 64;        // chunk rows per shared-memory tile
constexpr int kPad = 4;          // row padding (floats): rows stay 16-byte aligned
constexpr int kScanAhead = 8;    // chunks a thread of the carry pass loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);      // round to nearest even, as torch's .to()
}

// N consecutive floats of shared memory (16-byte loads where N allows; the
// callers keep p aligned to N floats, at most 4)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      out[i] = v.x; out[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// dt_s[i] = dt of the chunk's row i and la_s[i] = sum_{j <= i} dt_s[j] * A
// for i < kMaxChunk; rows at or past L, or past T, hold dt = 0.  Ends with
// __syncthreads.
__device__ __forceinline__ void chunk_log_decay(const float* dt, float A,
                                                int b, int h, int H, int T,
                                                int row0, int L, float* dt_s,
                                                float* la_s) {
  const int tid = threadIdx.x;
  if (tid < kMaxChunk) {
    const int t = row0 + tid;
    dt_s[tid] = (tid < L && t < T) ? dt[((size_t)b * T + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {                  // one warp: 4 rows a lane, then a shuffle scan
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      run += dt_s[tid * 4 + e] * A;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(kFull, incl, off);
      if (tid >= off) incl += n;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) la_s[tid * 4 + e] = excl + v[e];
  }
  __syncthreads();
}

struct Strides {
  long long b, t, h;   // batch, time, head (x) or group (B, C); last dim 1
};

// ---------------------------------------------------------------------------
// pass 1: each chunk's own state and decay
// ---------------------------------------------------------------------------

template <int S, int P> struct StateSmem {
  static constexpr int LB = S + kPad, LX = P + kPad;
  static constexpr int floats = 2 * kMaxChunk + kTile * LB + kTile * LX;
  static constexpr int bytes = floats * 4;
};

template <typename T, int S, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decay,
                       int Tn, int H, int G, int L, int nl, Strides xs,
                       Strides bs) {
  using Sm = StateSmem<S, P>;
  constexpr int RM = S / 16, RN = P / 16;
  extern __shared__ __align__(16) float smem[];
  float* dt_s = smem;
  float* la_s = dt_s + kMaxChunk;
  float* bw_s = la_s + kMaxChunk;          // [kTile][LB]: B o w, row-major
  float* x_s = bw_s + kTile * Sm::LB;      // [kTile][LX]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = c * L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  chunk_log_decay(dt, A[h], b, h, H, Tn, row0, L, dt_s, la_s);
  const float la_last = la_s[L - 1];
  float* w_s = dt_s;                       // w = exp(la_L - la) * dt, in place
  if (tid < kMaxChunk) w_s[tid] = expf(la_last - la_s[tid]) * dt_s[tid];
  __syncthreads();

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const T* xb = x + b * xs.b + h * xs.h;
  const T* bb = Bm + b * bs.b + g * bs.h;
  for (int l0 = 0; l0 < L; l0 += kTile) {
    for (int i = tid; i < kTile * S; i += kThreads) {
      const int l = i / S, s = i % S, r = l0 + l, t = row0 + r;
      bw_s[l * Sm::LB + s] =
          (r < L && t < Tn) ? to_f(bb[t * bs.t + s]) * w_s[r] : 0.f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int l = i / P, p = i % P, r = l0 + l, t = row0 + r;
      x_s[l * Sm::LX + p] = (r < L && t < Tn) ? to_f(xb[t * xs.t + p]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kTile; ++l) {
      float a[RM], v[RN];
      lds<RM>(bw_s + l * Sm::LB + ty * RM, a);
      lds<RN>(x_s + l * Sm::LX + tx * RN, v);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = states + (((size_t)b * H + h) * nl + c) * S * P;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      out[(ty * RM + i) * P + tx * RN + j] = acc[i][j];
  if (tid == 0) decay[((size_t)b * H + h) * nl + c] = expf(la_last);
}

// ---------------------------------------------------------------------------
// pass 2: the carry across chunks, in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_state_scan_kernel(float* __restrict__ states,
                      const float* __restrict__ decay,
                      const float* __restrict__ init_state,
                      float* __restrict__ final_state, int H, int nl, int SP) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= SP) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float run = init_state != nullptr ? init_state[bh * SP + e] : 0.f;
  float* st = states + bh * nl * SP + e;
  const float* dec = decay + bh * nl;
  // the loads of kScanAhead chunks go out before their stores: a load a
  // chunk would leave one load in flight per thread, a DRAM latency each
  for (int c0 = 0; c0 < nl; c0 += kScanAhead) {
    float own[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      own[j] = c0 + j < nl ? st[(size_t)(c0 + j) * SP] : 0.f;
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j) {
      if (c0 + j < nl) {
        st[(size_t)(c0 + j) * SP] = run;   // the state entering the chunk
        run = dec[c0 + j] * run + own[j];
      }
    }
  }
  final_state[bh * SP + e] = run;
}

// ---------------------------------------------------------------------------
// pass 3: the outputs
// ---------------------------------------------------------------------------

template <int S, int P> struct OutSmem {
  static constexpr int LR = kTile + kPad;    // row stride of the k-major tiles
  static constexpr int LX = P + kPad;
  static constexpr int c_floats = S * LR;    // C^T [S][kTile]
  static constexpr int state_floats = S * LX;                    // S_in [S][P]
  static constexpr int tile_floats = S * LR + kTile * LX + kTile * LR;
  static constexpr int buf_floats =
      state_floats > tile_floats ? state_floats : tile_floats;
  static constexpr int floats = 2 * kMaxChunk + c_floats + buf_floats;
  static constexpr int bytes = floats * 4;
};

template <typename T, int S, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ states,
                  T* __restrict__ y, int Tn, int H, int G, int L, int nl,
                  int slices, Strides xs, Strides bs, Strides cs) {
  using Sm = OutSmem<S, P>;
  constexpr int RN = P / 16;      // output columns a thread
  constexpr int RT = kTile / 16;  // output rows a thread, score columns a thread
  extern __shared__ __align__(16) float smem[];
  float* dt_s = smem;
  float* la_s = dt_s + kMaxChunk;
  float* c_s = la_s + kMaxChunk;            // [S][LR]: C^T of the 64 rows
  float* buf = c_s + Sm::c_floats;
  float* st_s = buf;                        // [S][LX]: the entering state
  float* b_s = buf;                         // [S][LR]: B^T of a 64-row tile
  float* x_s = b_s + S * Sm::LR;            // [kTile][LX]
  float* p_s = x_s + kTile * Sm::LX;        // [kTile][LR]: masked scores^T

  const int c = blockIdx.x / slices, r0 = (blockIdx.x % slices) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = c * L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  chunk_log_decay(dt, A[h], b, h, H, Tn, row0, L, dt_s, la_s);

  const T* xb = x + b * xs.b + h * xs.h;
  const T* bb = Bm + b * bs.b + g * bs.h;
  const T* cb = Cm + b * cs.b + g * cs.h;
  for (int i = tid; i < kTile * S; i += kThreads) {
    const int r = i / S, k = i % S, rr = r0 + r, t = row0 + rr;
    c_s[k * Sm::LR + r] = (rr < L && t < Tn) ? to_f(cb[t * cs.t + k]) : 0.f;
  }
  const float* st = states + (((size_t)b * H + h) * nl + c) * S * P;
  for (int i = tid; i < S * P; i += kThreads)
    st_s[(i / P) * Sm::LX + i % P] = st[i];
  __syncthreads();

  // inter-chunk: exp(la_t) (C_t . S_in)
  float acc[RT][RN];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < S; ++k) {
    float a[RT], v[RN];
    lds<RT>(c_s + k * Sm::LR + ty * RT, a);
    lds<RN>(st_s + k * Sm::LX + tx * RN, v);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float e = expf(la_s[r0 + ty * RT + i]);
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] *= e;
  }
  __syncthreads();                          // st_s is reused below

  // intra-chunk: the 64-row tiles of s on or below this slice's diagonal
  const int s_end = min(r0 + kTile, L);
  for (int s0 = 0; s0 < s_end; s0 += kTile) {
    for (int i = tid; i < kTile * S; i += kThreads) {
      const int s = i / S, k = i % S, rs = s0 + s, t = row0 + rs;
      b_s[k * Sm::LR + s] = (rs < L && t < Tn) ? to_f(bb[t * bs.t + k]) : 0.f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int s = i / P, p = i % P, rs = s0 + s, t = row0 + rs;
      x_s[s * Sm::LX + p] = (rs < L && t < Tn) ? to_f(xb[t * xs.t + p]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*RT.. against columns tx*RT.. of the tile
    float sc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
      float a[RT], v[RT];
      lds<RT>(c_s + k * Sm::LR + ty * RT, a);
      lds<RT>(b_s + k * Sm::LR + tx * RT, v);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) sc[i][j] = fmaf(a[i], v[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int rt = r0 + ty * RT + i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int rs = s0 + tx * RT + j;
        const float pv = (rs <= rt && rs < L)
                             ? sc[i][j] * expf(la_s[rt] - la_s[rs]) * dt_s[rs]
                             : 0.f;
        p_s[(tx * RT + j) * Sm::LR + ty * RT + i] = pv;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kTile; ++s) {
      float a[RT], v[RN];
      lds<RT>(p_s + s * Sm::LR + ty * RT, a);
      lds<RN>(x_s + s * Sm::LX + tx * RN, v);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int rr = r0 + ty * RT + i, t = row0 + rr;
    if (rr < L && t < Tn) {
      T* yr = y + (((size_t)b * Tn + t) * H + h) * P + tx * RN;
#pragma unroll
      for (int j = 0; j < RN; ++j) store(yr + j, acc[i][j]);
    }
  }
}

template <typename T, int S, int P>
int ssd_run(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, const void* init_state, void* y,
            void* final_state, void* states, void* decay, int Bn, int Tn,
            int H, int G, int L, Strides xs, Strides bs, Strides cs,
            cudaStream_t stream) {
  const int nl = (Tn + L - 1) / L;
  const int slices = (L + kTile - 1) / kTile;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<T, S, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, StateSmem<S, P>::bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_output_kernel<T, S, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OutSmem<S, P>::bytes);
  if (err != cudaSuccess) return (int)err;

  ssd_chunk_state_kernel<T, S, P>
      <<<dim3(nl, H, Bn), kThreads, StateSmem<S, P>::bytes, stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
          (float*)states, (float*)decay, Tn, H, G, L, nl, xs, bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_scan_kernel<<<dim3((S * P + kThreads - 1) / kThreads, H, Bn),
                          kThreads, 0, stream>>>(
      (float*)states, (const float*)decay, (const float*)init_state,
      (float*)final_state, H, nl, S * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_output_kernel<T, S, P>
      <<<dim3(nl * slices, H, Bn), kThreads, OutSmem<S, P>::bytes, stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
          (const T*)Cm, (const float*)states, (T*)y, Tn, H, G, L, nl, slices,
          xs, bs, cs);
  return (int)cudaGetLastError();
}

constexpr int kBadShape = -1;

}  // namespace

extern "C" {

// y, final_state = SSD(x, dt, A, B, C, init_state) in chunks of L rows.
// dtype 0: float32, 1: bfloat16 (x, B, C and y).  init_state may be null
// (zeros).  states [B*H*nl*S*P] and decay [B*H*nl] are float32 scratch,
// nl = ceil(T / L).  Strides are in elements; the last dims are contiguous.
int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* init_state, void* y,
               void* final_state, void* states, void* decay, int Bn, int Tn,
               int H, int G, int S, int P, int L, long long x_sb,
               long long x_st, long long x_sh, long long b_sb, long long b_st,
               long long b_sg, long long c_sb, long long c_st, long long c_sg,
               int dtype, void* stream) {
  if (L < 1 || L > kMaxChunk || G < 1 || H % G) return kBadShape;
  if (Bn == 0 || Tn == 0 || H == 0) return 0;
  const Strides xs{x_sb, x_st, x_sh}, bs{b_sb, b_st, b_sg},
      cs{c_sb, c_st, c_sg};
  cudaStream_t s = (cudaStream_t)stream;
#define SSD(T, SS, PP)                                                       \
  return ssd_run<T, SS, PP>(x, dt, A, Bm, Cm, init_state, y, final_state,    \
                            states, decay, Bn, Tn, H, G, L, xs, bs, cs, s)
#define SSD_SP(T)                                   \
  if (S == 16 && P == 16) SSD(T, 16, 16);           \
  if (S == 32 && P == 32) SSD(T, 32, 32);           \
  if (S == 64 && P == 64) SSD(T, 64, 64);           \
  if (S == 128 && P == 64) SSD(T, 128, 64);         \
  return kBadShape;
  if (dtype == 0) { SSD_SP(float) }
  SSD_SP(__nv_bfloat16)
#undef SSD_SP
#undef SSD
}

}  // extern "C"
