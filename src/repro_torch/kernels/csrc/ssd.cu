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
// x's dtype (contiguous) and the final state [B, H, S, P] float32.  Sums
// accumulate in float32, as the TPU kernel's preferred_element_type (the
// bf16 products below take their float32 operands as two bf16 terms).
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
// VMEM.  CUDA blocks run in parallel, so the carry becomes two passes around
// a scan, three launches in all:
//   1. each chunk's own state (B o w)^T @ x with w = dt o exp(la_L - la), and
//      its decay exp(la_L), into float32 scratch [B, H, nl, S, P] and
//      [B, H, nl];
//   2. ssd_state_scan_kernel, one thread per (batch, head, state element):
//      walks the nl chunks in order, replacing each chunk's own state by the
//      state entering it, and writes the final state (from init_state or 0);
//      it keeps 8 chunks' loads in flight a thread;
//   3. the outputs, from each chunk's entering state.
//
// bfloat16 (ssd_chunk_state_wgmma_kernel, ssd_output_wgmma_kernel): passes
// 1 and 3 run their products on the tensor cores, wgmma on 64-row warpgroup
// tiles (bf16 in, float32 accumulators), in blocks of two warpgroups that
// loop over heads.  Pass 3 has one block per (chunk, group, batch), 4 x 32
// x 1 = 128 at the full width: C B^T is computed once per (batch, chunk,
// group) and kept in registers for all the group's H / G heads (at G = 1 it
// is the same for all 24 heads); each head applies its own decay Gamma and
// dt to it.  Pass 1 shares only B between heads, so its blocks take a share
// of the group's heads each, sized for one wave of about two blocks an SM
// (256 blocks of 12 heads at the full width).  Per head a block streams x,
// dt and (pass 3) the entering state with cp.async, the next head's copies
// in flight while this head computes.  Every operand that is
// float32 in the algebra (x o w, the entering state, the masked scores M) is
// split into two bf16 terms, hi + lo, and multiplied twice: one rounding to
// bf16 of any of the three moved outputs past the bf16 tolerance, and of
// x o w the state past 2e-4, at the full width (tools/ssd_bf16_rounding.py
// emulates the arithmetic on the CPU); the two products keep ~16 bits.  Pass 1: own = B^T (x o w)_hi + B^T (x o w)_lo,
// B^T the MN-major A operand, x o w the MN-major B operand.  Pass 3: y =
// e^{la_t} (C S_hi + C S_lo) + M_hi x + M_lo x, C K-major from shared
// memory, S_in MN-major, M built in registers from the C B^T fragment (an
// m64n128 accumulator fragment is the A fragment of the next product) and
// x MN-major as it lies; rows t < 64 skip the columns s >= 64 (above the
// diagonal).  Tiles are 128 chunk rows, zero-filled past L and T, so chunks
// below 128 rows waste work but not correctness; S below 64 is zero-padded
// to one 64-column block and P (<= 64) is padded in the N dimension.  x, B
// and C are strided views: 16-byte cp.async copies where every row start is
// 16-byte aligned (the model's views are), element loads otherwise.  Shared
// memory at S = 128, P = 64: 99 KB in pass 1, 195 KB in pass 3.
//
// float32 (ssd_chunk_state_kernel, ssd_output_kernel): the products stay on
// the CUDA cores in float32 (TF32 would keep ~3 decimal digits; the LM's
// card-against-CPU gate needs float32): pass 1 one block per (chunk, head,
// batch) with 64-row tiles of B o w and x (52 KB), each thread an 8 x 4
// register tile; pass 3 one block per (chunk, 64-row slice, head, batch)
// with C's rows and, in turn, the entering state or one 64-row tile of B, x
// and the masked scores (105 KB, two blocks an SM), 4 x 4 register tiles,
// only the score tiles on or below the diagonal.
//
// Bound at the full width (B = 4, T = 4096, H = 24, G = 1, bf16): ~0.11 GB
// of x, y, B, C, dt and the final state, 0.034 ms at 3.35 TB/s, above the
// least operations (C B^T once per group) at the bf16 peak.  The float32
// state scratch moves ~400 MB a call (pass 1 writes it, the carry reads and
// writes it, pass 3 reads it): ~0.12 ms, this design's floor; folding the
// carry into the passes (a chained scan) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kTile = 64;        // chunk rows per shared-memory tile
constexpr int kPad = 4;          // row padding (floats): rows stay 16-byte aligned
constexpr int kScanAhead = 8;    // chunks a thread of the carry pass loads at once
constexpr unsigned kFull = 0xffffffffu;

// the float32 passes' loads and stores (their T is float)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

constexpr int kBadShape = -1;

cudaError_t ssd_carry(void* states, void* decay, const void* init_state,
                      void* final_state, int Bn, int H, int nl, int SP,
                      cudaStream_t stream) {
  ssd_state_scan_kernel<<<dim3((SP + kThreads - 1) / kThreads, H, Bn),
                          kThreads, 0, stream>>>(
      (float*)states, (const float*)decay, (const float*)init_state,
      (float*)final_state, H, nl, SP);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: passes 1 and 3 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;      // two warpgroups
constexpr int kLT = 128;             // chunk rows a tile (L <= 128, zero-padded)
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of the bf16 passes.  Swizzled tiles (hopper.cuh) of
// kLT rows: B and C as [kLT][SP] (S padded to a 64-column block), x and
// x o w as [kLT][64] (P <= 64, the columns past P never stored); the
// entering state as [SP rows][64].  Raw copies: x rows [kLT][P] bf16 and
// the state [S][P] float32, two buffers each (the next head's in flight).
template <int S, int P> struct WgSsd {
  static constexpr int SP = S < 64 ? 64 : S;
  static constexpr int SBLK = SP / 64;
  static constexpr int TILE_SP = SBLK * kLT * 128;
  static constexpr int TILE_64 = kLT * 128;
  static constexpr int STATE_SW = SP * 128;
  static constexpr int XRAW = kLT * P * 2;
  static constexpr int SRAW = S * P * 4;
  static constexpr int pass1_bytes =
      TILE_SP + 2 * TILE_64 + 2 * XRAW + 4 * kLT * 4 + 1024;
  static constexpr int pass3_bytes = 2 * TILE_SP + 2 * TILE_64 +
                                     2 * STATE_SW + 2 * SRAW + 3 * kLT * 4 +
                                     1024;
  static_assert(P % 8 == 0 && P <= 64 && S % 16 == 0 && S <= 128, "shape");
};

__device__ __forceinline__ uint32_t swz(int r, int c) {   // chunk c of row r
  return r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// eight bf16 at any 2-byte-aligned address
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  uint4 v;
  v.x = u[0] | ((uint32_t)u[1] << 16);
  v.y = u[2] | ((uint32_t)u[3] << 16);
  v.z = u[4] | ((uint32_t)u[5] << 16);
  v.w = u[6] | ((uint32_t)u[7] << 16);
  return v;
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// rows [0, kLT) of a bf16 [rows][W] matrix, row r at src + r * rs elements,
// into a swizzled tile; rows at or past nrows and columns at or past W
// become zeros.  vec: 16-byte cp.async copies (src and rs 16-byte aligned),
// else element loads that need no alignment.
template <int W>
__device__ __forceinline__ void load_sw(uint32_t dst,
                                        const __nv_bfloat16* src,
                                        long long rs, int nrows, bool vec) {
  constexpr int CPR = (W < 64 ? 64 : W) / 8;
  for (int i = threadIdx.x; i < kLT * CPR; i += kWgThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nrows && c * 8 < W;
    const uint32_t d = dst + (c >> 3) * (kLT * 128) + swz(r, c);
    const __nv_bfloat16* s = ok ? src + r * rs + c * 8 : src;
    if (vec) cp_async16(d, s, ok ? 16 : 0);
    else st_shared16(d, ok ? load8(s) : make_uint4(0, 0, 0, 0));
  }
}

// rows [0, kLT) of a bf16 [rows][P] matrix into a row-major [kLT][P] copy
template <int P>
__device__ __forceinline__ void load_rows_bf16(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               long long rs, int nrows,
                                               bool vec) {
  constexpr int CPR = P / 8;
  for (int i = threadIdx.x; i < kLT * CPR; i += kWgThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nrows;
    const __nv_bfloat16* s = ok ? src + r * rs + c * 8 : src;
    if (vec) cp_async16(dst + i * 16, s, ok ? 16 : 0);
    else st_shared16(dst + i * 16, ok ? load8(s) : make_uint4(0, 0, 0, 0));
  }
}

// dt of head h for the chunk's rows (zeros past nrows) into dst [kLT]
__device__ __forceinline__ void load_dt(uint32_t dst, const float* dtb,
                                        int H, int h, int nrows) {
  const int r = threadIdx.x;
  if (r < kLT)
    cp_async4(dst + r * 4, r < nrows ? dtb + (size_t)r * H + h : dtb,
              r < nrows ? 4 : 0);
}

// la[i] = unit * sum_{j <= i} dt[j] * A over the kLT rows; one warp
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float A,
                                             float unit, float* la,
                                             int lane) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += dt_s[lane * 4 + e] * A;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) la[lane * 4 + e] = (excl + v[e]) * unit;
}

// a = hi + lo to ~16 bits: hi the bf16 rounding of a, lo that of the rest
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a0 - hf.x, a1 - hf.y);
}

// pass 1, one block per (chunk, group, batch, hpb of the group's heads),
// looping over its heads: own[h] = B^T (x_h o w_h), w = dt o exp(la_L -
// la); B^T is the MN-major A operand (read once per block), x o w the
// MN-major B operand as bf16 hi + lo; warpgroup wg computes state rows
// [64 wg, 64 wg + 64).  Nothing is shared between heads but B, so the
// heads are spread over blocks for about two blocks an SM.
template <int S, int P>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_chunk_state_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                             const float* __restrict__ dt,
                             const float* __restrict__ A,
                             const __nv_bfloat16* __restrict__ Bm,
                             float* __restrict__ states,
                             float* __restrict__ decay, int Tn, int H, int G,
                             int L, int nl, int hpb, Strides xs, Strides bs,
                             int vec) {
  using W = WgSsd<S, P>;
  extern __shared__ __align__(1024) uint8_t ssd_smem[];
  const uint32_t raw = smem_u32(ssd_smem);
  const uint32_t sB = (raw + 1023u) & ~1023u;    // [kLT][SP] swizzled
  const uint32_t sXh = sB + W::TILE_SP;          // x o w, hi: [kLT][64]
  const uint32_t sXl = sXh + W::TILE_64;         // x o w, lo
  const uint32_t sXr = sXl + W::TILE_64;         // 2 x raw x [kLT][P]
  uint8_t* gen = ssd_smem + (sB - raw);          // generic pointer to sB
  float* dt_s = reinterpret_cast<float*>(gen + (sXr - sB) + 2 * W::XRAW);
  float* la_s = dt_s + 2 * kLT;
  float* w_s = la_s + kLT;

  // block (c, g * hsplit + part, b): heads [h0, h1) of group g
  const int hpg = H / G, hsplit = (hpg + hpb - 1) / hpb;
  const int c = blockIdx.x, g = blockIdx.y / hsplit, b = blockIdx.z;
  const int h0 = g * hpg + (blockIdx.y % hsplit) * hpb;
  const int nh = min(hpb, (g + 1) * hpg - h0);
  const int row0 = c * L, nrows = min(L, Tn - row0);
  const int tid = threadIdx.x, wg = tid / 128;
  const __nv_bfloat16* xb = x + b * xs.b + (long long)row0 * xs.t;
  const float* dtb = dt + ((size_t)b * Tn + row0) * H;

  auto load_head = [&](int j) {
    const int h = h0 + j;
    load_rows_bf16<P>(sXr + (j & 1) * W::XRAW, xb + h * xs.h, xs.t, nrows,
                      vec);
    load_dt(smem_u32(dt_s + (j & 1) * kLT), dtb, H, h, nrows);
  };
  load_sw<S>(sB, Bm + b * bs.b + (long long)row0 * bs.t + g * bs.h, bs.t,
             nrows, vec);
  load_head(0);
  cp_async_commit();

  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    if (j + 1 < nh) load_head(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                // head j (and B) landed
    __syncthreads();
    if (tid < 32) {
      const float* d = dt_s + (j & 1) * kLT;
      chunk_cumsum(d, A[h], 1.f, la_s, tid);
      __syncwarp();
      const float la_last = la_s[L - 1];   // rows past T hold dt = 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = tid * 4 + e;
        w_s[r] = expf(la_last - la_s[r]) * d[r];
      }
      if (tid == 0) decay[((size_t)b * H + h) * nl + c] = expf(la_last);
    }
    __syncthreads();
    {   // x o w, as bf16 hi + lo, into the swizzled B operands
      constexpr int CPR = P / 8;
      const uint8_t* xr = gen + (sXr - sB) + (j & 1) * W::XRAW;
      for (int i = tid; i < kLT * CPR; i += kWgThreads) {
        const int r = i / CPR, cc = i % CPR;
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(xr + i * 16), f);
        const float wr = w_s[r];
        uint4 hi, lo;
        split2(f[0] * wr, f[1] * wr, hi.x, lo.x);
        split2(f[2] * wr, f[3] * wr, hi.y, lo.y);
        split2(f[4] * wr, f[5] * wr, hi.z, lo.z);
        split2(f[6] * wr, f[7] * wr, hi.w, lo.w);
        st_shared16(sXh + swz(r, cc), hi);
        st_shared16(sXl + swz(r, cc), lo);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (wg < W::SBLK) {
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kLT / 16; ++kk) {
        const uint64_t da =
            sw128_desc(sB + wg * kLT * 128 + kk * 16 * 128, kLT * 128);
        wgmma_ss_n64<1, 1>(acc, da,
                           sw128_desc(sXh + kk * 16 * 128, kLT * 128), kk > 0);
        wgmma_ss_n64<1, 1>(acc, da,
                           sw128_desc(sXl + kk * 16 * 128, kLT * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<32>(acc);
      const int lane = tid % 32, gid = lane / 4, tig = lane % 4;
      const int s_lo = wg * 64 + ((tid % 128) / 32) * 16 + gid;
      float* out = states + (((size_t)b * H + h) * nl + c) * S * P;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s_lo + 8 * hh;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int p = 8 * jj + 2 * tig;
          if (s < S && p < P)
            *reinterpret_cast<float2*>(out + s * P + p) =
                make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
        }
      }
    }
    __syncthreads();                   // x o w, la, w and buffer j free
  }
}

// pass 3, one block per (chunk, group, batch): C B^T once, in registers
// (warpgroup wg holds rows t in [64 wg, 64 wg + 64), all 128 columns s),
// then for each head of the group
//   y = e^{la_t} (C S_in) + M x,  M = (C B^T) o Gamma o dt (s <= t)
// with S_in and M as bf16 hi + lo: C S_in from shared memory (C K-major,
// S_in MN-major), M from registers (the C B^T fragment is M's A fragment)
// times x (MN-major, read as it lies).  Rows t < 64 stop at column 64.
template <int S, int P>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_output_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const __nv_bfloat16* __restrict__ Bm,
                        const __nv_bfloat16* __restrict__ Cm,
                        const float* __restrict__ states,
                        __nv_bfloat16* __restrict__ y, int Tn, int H, int G,
                        int L, int nl, Strides xs, Strides bs, Strides cs,
                        int vec) {
  using W = WgSsd<S, P>;
  constexpr int SP = W::SP;
  extern __shared__ __align__(1024) uint8_t ssd_smem[];
  const uint32_t raw = smem_u32(ssd_smem);
  const uint32_t sC = (raw + 1023u) & ~1023u;    // [kLT][SP] swizzled
  const uint32_t sB = sC + W::TILE_SP;           // [kLT][SP] swizzled
  const uint32_t sX = sB + W::TILE_SP;           // 2 x [kLT][64] swizzled
  const uint32_t sSh = sX + 2 * W::TILE_64;      // S_in hi [SP][64]
  const uint32_t sSl = sSh + W::STATE_SW;        // S_in lo
  const uint32_t sSr = sSl + W::STATE_SW;        // 2 x raw S_in [S][P] f32
  uint8_t* gen = ssd_smem + (sC - raw);
  float* dt_s = reinterpret_cast<float*>(gen + (sSr - sC) + 2 * W::SRAW);
  float* la2_s = dt_s + 2 * kLT;                 // la in log2 units

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int hpg = H / G;
  const int row0 = c * L, nrows = min(L, Tn - row0);
  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int t_lo = wg * 64 + ((tid % 128) / 32) * 16 + gid;   // and t_lo + 8
  const __nv_bfloat16* xb = x + b * xs.b + (long long)row0 * xs.t;
  const float* dtb = dt + ((size_t)b * Tn + row0) * H;

  auto load_head = [&](int j) {
    const int h = g * hpg + j;
    load_sw<P>(sX + (j & 1) * W::TILE_64, xb + h * xs.h, xs.t, nrows, vec);
    const float* st = states + (((size_t)b * H + h) * nl + c) * S * P;
    for (int i = tid; i < S * P / 4; i += kWgThreads)
      cp_async16(sSr + (j & 1) * W::SRAW + i * 16, st + i * 4, 16);
    load_dt(smem_u32(dt_s + (j & 1) * kLT), dtb, H, h, nrows);
  };
  load_sw<S>(sC, Cm + b * cs.b + (long long)row0 * cs.t + g * cs.h, cs.t,
             nrows, vec);
  load_sw<S>(sB, Bm + b * bs.b + (long long)row0 * bs.t + g * bs.h, bs.t,
             nrows, vec);
  load_head(0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // C B^T: [64 rows t, 128 columns s] a warpgroup, f32 in registers
  float cb[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk)
    wgmma_ss_n128(
        cb,
        sw128_desc(sC + wg * 64 * 128 + (kk / 4) * kLT * 128 + (kk % 4) * 32,
                   16),
        sw128_desc(sB + (kk / 4) * kLT * 128 + (kk % 4) * 32, 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<64>(cb);

  for (int j = 0; j < hpg; ++j) {
    const int h = g * hpg + j;
    if (j + 1 < hpg) load_head(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                // head j landed
    __syncthreads();
    const float* dts = dt_s + (j & 1) * kLT;
    if (tid < 32) chunk_cumsum(dts, A[h], kLog2e, la2_s, tid);
    {   // S_in as bf16 hi + lo, [SP rows][64], zeros outside [S][P]
      const float* sr = reinterpret_cast<const float*>(
          gen + (sSr - sC) + (j & 1) * W::SRAW);
      for (int i = tid; i < SP * 8; i += kWgThreads) {
        const int r = i / 8, cc = i % 8;
        uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
        if (r < S && cc * 8 < P) {
          const float4 a = *reinterpret_cast<const float4*>(sr + r * P + cc * 8);
          const float4 e = *reinterpret_cast<const float4*>(sr + r * P + cc * 8 + 4);
          split2(a.x, a.y, hi.x, lo.x);
          split2(a.z, a.w, hi.y, lo.y);
          split2(e.x, e.y, hi.z, lo.z);
          split2(e.z, e.w, hi.w, lo.w);
        }
        st_shared16(sSh + swz(r, cc), hi);
        st_shared16(sSl + swz(r, cc), lo);
      }
    }
    fence_proxy_async();
    __syncthreads();

    // C S_in
    float acc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk) {
      const uint64_t da = sw128_desc(
          sC + wg * 64 * 128 + (kk / 4) * kLT * 128 + (kk % 4) * 32, 16);
      wgmma_ss_n64<0, 1>(acc, da, sw128_desc(sSh + kk * 16 * 128, SP * 128),
                         kk > 0);
      wgmma_ss_n64<0, 1>(acc, da, sw128_desc(sSl + kk * 16 * 128, SP * 128),
                         1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<32>(acc);
    const float lt[2] = {la2_s[t_lo], la2_s[t_lo + 8]};
    const float et[2] = {exp2f(lt[0]), exp2f(lt[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= et[(i >> 1) & 1];

    // + M x, 64 columns s at a time: warpgroup 0 (t < 64) needs only the first
    const uint32_t xs_h = sX + (j & 1) * W::TILE_64;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half > wg) break;
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int jc = 8 * half + jj;            // column group of 8
        const int s0 = 8 * jc + 2 * tig;
        const float ls0 = la2_s[s0], ls1 = la2_s[s0 + 1];
        const float d0 = dts[s0], d1 = dts[s0 + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t_lo + 8 * hh;
          const float m0 =
              s0 <= t ? cb[4 * jc + 2 * hh] * fast_exp2(lt[hh] - ls0) * d0
                      : 0.f;
          const float m1 = s0 + 1 <= t ? cb[4 * jc + 2 * hh + 1] *
                                             fast_exp2(lt[hh] - ls1) * d1
                                       : 0.f;
          split2(m0, m1, ph[2 * jj + hh], pl[2 * jj + hh]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const uint64_t db =
            sw128_desc(xs_h + (4 * half + k4) * 16 * 128, kLT * 128);
        wgmma_rs_n64(acc, &ph[4 * k4], db);
        wgmma_rs_n64(acc, &pl[4 * k4], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<32>(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t_lo + 8 * hh;
      if (t >= nrows) continue;
      __nv_bfloat16* yr = y + (((size_t)b * Tn + row0 + t) * H + h) * P;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = 8 * jj + 2 * tig;
        if (p < P)
          *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
              acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
      }
    }
    __syncthreads();                   // S_in, x, dt of head j free
  }
}

template <int S, int P>
int ssd_run_f32(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* init_state, void* y,
                void* final_state, void* states, void* decay, int Bn, int Tn,
                int H, int G, int L, Strides xs, Strides bs, Strides cs,
                cudaStream_t stream) {
  using T = float;
  const int nl = (Tn + L - 1) / L;
  const int slices = (L + kTile - 1) / kTile;
  static unsigned ready = 0;           // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T, S, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               StateSmem<S, P>::bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_output_kernel<T, S, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               OutSmem<S, P>::bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) ready |= 1u << dev;
  }

  ssd_chunk_state_kernel<T, S, P>
      <<<dim3(nl, H, Bn), kThreads, StateSmem<S, P>::bytes, stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
          (float*)states, (float*)decay, Tn, H, G, L, nl, xs, bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = ssd_carry(states, decay, init_state, final_state, Bn, H, nl, S * P,
                  stream);
  if (err != cudaSuccess) return (int)err;
  ssd_output_kernel<T, S, P>
      <<<dim3(nl * slices, H, Bn), kThreads, OutSmem<S, P>::bytes, stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
          (const T*)Cm, (const float*)states, (T*)y, Tn, H, G, L, nl, slices,
          xs, bs, cs);
  return (int)cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p, Strides s) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.h % 8 == 0;
}

template <int S, int P>
int ssd_run_bf16(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* init_state,
                 void* y, void* final_state, void* states, void* decay,
                 int Bn, int Tn, int H, int G, int L, Strides xs, Strides bs,
                 Strides cs, cudaStream_t stream) {
  using W = WgSsd<S, P>;
  using bf = __nv_bfloat16;
  const int nl = (Tn + L - 1) / L;
  if (G > 65535 || Bn > 65535) return kBadShape;
  static unsigned ready = 0;           // devices whose attributes are set
  static int sms[32];                  // their SM counts
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int nsm = dev < 32 ? sms[dev] : 0;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) sms[dev] = nsm;
    err = cudaFuncSetAttribute(ssd_chunk_state_wgmma_kernel<S, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::pass1_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_output_wgmma_kernel<S, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::pass3_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) ready |= 1u << dev;
  }
  // 16-byte copies where every row start is 16-byte aligned (the model's
  // views are); element loads otherwise
  const int vec = aligned16(x, xs) && aligned16(Bm, bs) && aligned16(Cm, cs);
  // pass 1: heads per block for one wave of about two blocks an SM
  const int hpg = H / G;
  const long long work = (long long)nl * Bn * H;
  const int hpb = (int)std::min<long long>(
      hpg, std::max<long long>(1, (work + 2 * nsm - 1) / (2 * nsm)));
  const int hsplit = (hpg + hpb - 1) / hpb;
  if ((long long)G * hsplit > 65535) return kBadShape;
  ssd_chunk_state_wgmma_kernel<S, P>
      <<<dim3(nl, G * hsplit, Bn), kWgThreads, W::pass1_bytes, stream>>>(
          (const bf*)x, (const float*)dt, (const float*)A, (const bf*)Bm,
          (float*)states, (float*)decay, Tn, H, G, L, nl, hpb, xs, bs, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = ssd_carry(states, decay, init_state, final_state, Bn, H, nl, S * P,
                  stream);
  if (err != cudaSuccess) return (int)err;
  ssd_output_wgmma_kernel<S, P>
      <<<dim3(nl, G, Bn), kWgThreads, W::pass3_bytes, stream>>>(
      (const bf*)x, (const float*)dt, (const float*)A, (const bf*)Bm,
      (const bf*)Cm, (const float*)states, (bf*)y, Tn, H, G, L, nl, xs, bs,
      cs, vec);
  return (int)cudaGetLastError();
}


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
#define SSD(RUN, SS, PP)                                                    \
  return RUN<SS, PP>(x, dt, A, Bm, Cm, init_state, y, final_state, states,  \
                     decay, Bn, Tn, H, G, L, xs, bs, cs, s)
#define SSD_SP(RUN)                                  \
  if (S == 16 && P == 16) SSD(RUN, 16, 16);          \
  if (S == 32 && P == 32) SSD(RUN, 32, 32);          \
  if (S == 64 && P == 64) SSD(RUN, 64, 64);          \
  if (S == 128 && P == 64) SSD(RUN, 128, 64);        \
  return kBadShape;
  if (dtype == 0) { SSD_SP(ssd_run_f32) }
  SSD_SP(ssd_run_bf16)
#undef SSD_SP
#undef SSD
}

}  // extern "C"
