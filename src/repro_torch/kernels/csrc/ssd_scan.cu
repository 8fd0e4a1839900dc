// K2: Mamba2 chunked SSD scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_kernel
// (src/repro/kernels/ssd_scan.py:35, launched by ssd_scan() there). Same
// function: x (b, s, h, p), dt (b, s, h) f32, A (h,) f32, B and C (b, s, n)
// -> y (b, s, h, p) in x's dtype and the final state (b, h, p, n) in f32.
// Per chunk of c positions and per head:
//   cum_i   = sum_{k <= i} dt_k A
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i . state
//   state  <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// with the state zero at chunk 0, as in the TPU kernel, or an optional
// initial state (ssd_chunked's init_state) so that every multi-token scan
// of apply_mamba can run here. x may be f32 or bf16; B and C (one type for
// both) may be f32 or bf16 independently of x. Sums are f32.
//
// C . B^T: with n_groups = 1, B and C carry no head axis. The scalar
// kernel reads it from an f32 scratch (b, n_chunks, c, c) that cb_kernel
// fills once per (batch, chunk), lower-triangle 32x32 tiles only, so that a
// per-head CTA does not repeat the product once per head. The tensor-core
// kernel forms each 16 x 16 tile it needs itself, from the C and B it holds
// in shared memory anyway, straight into registers (fused: no scratch, no
// extra launch, no global reads in the inner loop).
//
// bf16 x and bf16 B/C (ssd_mma_kernel, the serving path): tensor cores.
//   * One CTA of 8 warps per (batch, head, P-slice): the columns of P are
//     independent in x, y and the state, so a CTA takes PS = P/2 of them
//     (P = 8: all 8). At the serving shape that is 8 * 80 * 2 = 1280 CTAs.
//     Hopper blocks run in no order, so the TPU's sequential chunk axis
//     (its grid axis 1, with the state in VMEM scratch) becomes a loop over
//     chunks inside the CTA.
//   * The (PS, N) f32 state lives in registers as mma accumulators (warp w
//     owns rows n = 16w..16w+15), and is mirrored once per chunk into shared
//     memory as bf16 hi + lo parts for the C . state^T product.
//   * The products run on mma.sync.m16n8k16, bf16 in, f32 accumulate:
//       C B^T                   per 16 x 16 tile on or below the diagonal;
//                               exact bf16 inputs, f32 sums, as in cb_kernel;
//       y_diag = L X            A = L formed in f32 in registers from that
//                               tile, cum and dt, split hi + lo;
//                               B = x (exact bf16, ldmatrix.trans); only the
//                               16-column tiles on or below the diagonal;
//       y_off  = e^cum (C state^T)  A = C (exact bf16, ldmatrix); B = the
//                               state hi + lo; the e^cum_i row scaling stays
//                               out of the operand, on the f32 accumulator;
//       state  = e^cum_last state + B^T (w X)   A = B^T (exact bf16,
//                               ldmatrix.trans); B = w_j x_j, scaled in f32 in
//                               registers and split hi + lo.
//     Every f32 operand is split into bf16 hi = bf16(v) and lo = bf16(v - hi)
//     and multiplied twice, so it keeps about 16 significant bits; no
//     operand is rounded to bf16 alone. The products are therefore as
//     accurate as the scalar f32 kernel's to about 1e-5 relative.
//   * L is built only for j <= i < c: cum falls along the chunk, so
//     exp(cum_i - cum_j) above the diagonal can overflow to inf, and inf * 0
//     is NaN; the mask is applied before the exp. That exp is the fast
//     __expf: its argument x is <= 0 and its error, 2 + 1.16|x| ulp as
//     NVIDIA documents it, grows only where e^x, and the term, is small.
//     The scan's e^cum and w use the full expf.
//   * cp.async copies: x and dt of the next chunk are in flight during this
//     chunk's products (two stages); C and B have one buffer each, refilled
//     for the next chunk once every warp is done with them. Three barriers
//     per chunk; a warp goes from its rows of y to its rows of the state
//     without waiting for the others.
//   * cum = cumsum(dt A) is a warp scan (__shfl_up_sync), 4 positions a lane,
//     run by warp 0 while every warp forms its C state^T (which needs no cum).
//   * Padding: chunk and N are rounded up to multiples of 16 with zeros in
//     shared memory (zeroed once; the copies never touch the padding), so one
//     path covers every chunk 1..128 dividing S, every N a multiple of 4 up
//     to 128 (8-byte copies when N % 8 != 0), and P in {8, 16, 32, 64}.
//   * Shared memory 110,080 B at c = 128, N = 128, PS = 32, so two CTAs (16
//     warps) fit on an SM; __launch_bounds__(256, 2) caps registers at 128.
//
// Any f32 operand (f32 x, or f32 B/C) runs ssd_scan_kernel, the scalar
// kernel of the first port, unchanged: its 2e-4 tolerance against
// ssd_chunked is out of reach of TF32. The dtypes alone choose the kernel.
// One CTA per (batch, head) owns its (P, N) state in shared memory (32 KB
// of f32 at P=64, N=128, stored [n][p]). Per chunk, three register-tiled
// f32 products over shared memory, each thread owning 4 adjacent columns
// of P and P/8 strided rows: y = L X; y += (exp(cum) C) . state^T; and
// state = exp(cum_last) state + (w B)^T X with w_j = exp(cum_last - cum_j)
// dt_j. One work buffer holds L, then C, then B; rows are padded to a
// multiple of 4 with zeros. 137 KB of dynamic shared memory at c = 128,
// P = 64, N = 128: one CTA of 256 threads per SM.
//
// Bound at the serving shape of mamba2-2.7b (b=8, s=512, h=80, p=64, n=128,
// bf16 x/B/C, f32 dt and state): bytes x 41.9 MB + y 41.9 MB + dt 1.3 MB +
// B, C 2.1 MB + final state 21.0 MB = 108 MB, 32 us at 3.35 TB/s; about
// 13.5 GFLOP of multiply-adds, 14 us at bf16's 989 TFLOP/s. So it is
// bytes-bound near 32 us per launch. The tensor-core kernel does about
// about three times those operations (the hi + lo halves, and C B^T once
// per (head, P-slice) instead of once per batch row) with mma.sync, which reaches
// well under 989 TFLOP/s; wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int NT = 256;          // threads per scan CTA
constexpr int MAX_CHUNK = 128;   // largest chunk (and largest N)
constexpr int CB_TILE = 32;      // C . B^T tile edge

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// cb[b, z, i, j] = sum_n C[b, z*c + i, n] * B[b, z*c + j, n] for the tiles
// on or below the diagonal. grid (b * n_chunks, tiles, tiles), block (32, 8).
template <typename TBC>
__global__ void __launch_bounds__(CB_TILE * 8)
cb_kernel(const TBC* __restrict__ Cm, const TBC* __restrict__ Bm,
          float* __restrict__ cb, int S, int N, int chunk) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.z;
  if (tj > ti) return;                     // above the diagonal: never read
  __shared__ float cs[CB_TILE][CB_TILE + 1];
  __shared__ float bs[CB_TILE][CB_TILE + 1];
  const int nc = S / chunk;
  const int b = blockIdx.x / nc;
  const int z = blockIdx.x % nc;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(z) * chunk;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i0 = ti * CB_TILE;
  const int j0 = tj * CB_TILE;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += CB_TILE) {
    const int n = n0 + tx;
    for (int r = ty; r < CB_TILE; r += 8) {
      const int i = i0 + r;
      const int j = j0 + r;
      cs[r][tx] = (i < chunk && n < N) ? to_f32(Cm[(row0 + i) * N + n]) : 0.f;
      bs[r][tx] = (j < chunk && n < N) ? to_f32(Bm[(row0 + j) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < CB_TILE; ++k) {
      const float bv = bs[tx][k];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(cs[ty + 8 * r][k], bv, acc[r]);
    }
    __syncthreads();
  }
  float* out = cb + static_cast<size_t>(blockIdx.x) * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 8 * r;
    const int j = j0 + tx;
    if (i < chunk && j < chunk) out[i * chunk + j] = acc[r];
  }
}

// Shared memory of the scan CTA, in floats; every region starts 16-byte aligned.
__host__ __device__ __forceinline__ int smem_floats(int P, int N, int c) {
  const int c4 = (c + 3) & ~3;
  const int ldl = c4 + 4;
  const int ldc = N + 4;
  return c4 * P + N * (P + 4) + c * (ldl > ldc ? ldl : ldc) + 4 * c4;
}

template <typename TX, typename TBC, int P>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TBC* __restrict__ Bm,
                const TBC* __restrict__ Cm, const float* __restrict__ cb,
                const float* __restrict__ init_state, TX* __restrict__ y,
                float* __restrict__ final_state, int S, int H, int N, int c) {
  constexpr int P4 = P / 4;            // float4 columns of a row of P
  constexpr int TR = NT / P4;          // thread rows
  constexpr int RY = MAX_CHUNK / TR;   // row slots per thread (P / 8)
  static_assert(RY * TR == MAX_CHUNK, "row slots must cover the largest chunk");

  extern __shared__ float4 smem4[];
  const int c4 = (c + 3) & ~3;
  const int ldl = c4 + 4;              // row stride of L
  const int ldc = N + 4;               // row stride of C and B
  const int lds = P + 4;               // row stride of the state, stored [n][p]
  float* xs = reinterpret_cast<float*>(smem4);   // c4 x P (rows past c are zero)
  float* ss = xs + c4 * P;                       // N x lds
  float* ws = ss + N * lds;                      // L (c x ldl), then C, then B (c x ldc)
  float* cum = ws + c * (ldl > ldc ? ldl : ldc); // c4 each:
  float* dts = cum + c4;
  float* ecum = dts + c4;                        // exp(cum_i)
  float* wj = ecum + c4;                         // exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int tx = tid % P4;
  const int ty = tid / P4;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int nc = S / c;
  const float a = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;  // x / y stride between positions
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N;

  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N;
    const int n = e % N;
    ss[n * lds + p] = init_state != nullptr ? init_state[st_off + e] : 0.f;
  }

  for (int z = 0; z < nc; ++z) {
    const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(z) * c;

    // 1. the chunk's x (as f32) and dt
    for (int e = tid; e < c4 * P4; e += NT) {
      const int i = e / P4;
      const int q = e % P4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < c) v = load4(x + (t0 + i) * xrow + h * P + q * 4);
      reinterpret_cast<float4*>(xs)[e] = v;
    }
    for (int i = tid; i < c; i += NT) dts[i] = dt[(t0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {                       // cum = cumsum(dt * A), in order
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[c - 1];
    for (int i = tid; i < c; i += NT) {
      ecum[i] = expf(cum[i]);
      wj[i] = expf(cum_last - cum[i]) * dts[i];
    }

    // 2. L[i][j] = CB[i][j] exp(cum_i - cum_j) dt_j for j <= i, else 0
    const float* cbz = cb + (static_cast<size_t>(b) * nc + z) * c * c;
    for (int e = tid; e < c * ldl; e += NT) {
      const int i = e / ldl;
      const int j = e % ldl;
      float l = 0.f;
      if (j <= i) l = cbz[i * c + j] * expf(cum[i] - cum[j]) * dts[j];
      ws[e] = l;
    }
    __syncthreads();

    // 3. y = L X, rows i = ty + r * TR, columns 4 tx .. 4 tx + 3
    float4 acc[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < c4; j += 4) {
      float4 xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = reinterpret_cast<const float4*>(xs)[(j + k) * P4 + tx];
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int i = ty + r * TR;
        if (i < c) {
          const float4 l = *reinterpret_cast<const float4*>(ws + i * ldl + j);
          fma4(acc[r], l.x, xv[0]);
          fma4(acc[r], l.y, xv[1]);
          fma4(acc[r], l.z, xv[2]);
          fma4(acc[r], l.w, xv[3]);
        }
      }
    }
    __syncthreads();                      // L is no longer read

    // 4. exp(cum_i) C_i into the work buffer
    const int N4 = N / 4;
    for (int e = tid; e < c * N4; e += NT) {
      const int i = e / N4;
      const int q = e % N4;
      store4(ws + i * ldc + q * 4, scale4(load4(Cm + (t0 + i) * N + q * 4), ecum[i]));
    }
    __syncthreads();

    // 5. y += (exp(cum) C) state^T, then store y
    for (int n = 0; n < N; n += 4) {
      float4 sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sv[k] = *reinterpret_cast<const float4*>(ss + (n + k) * lds + 4 * tx);
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int i = ty + r * TR;
        if (i < c) {
          const float4 cv = *reinterpret_cast<const float4*>(ws + i * ldc + n);
          fma4(acc[r], cv.x, sv[0]);
          fma4(acc[r], cv.y, sv[1]);
          fma4(acc[r], cv.z, sv[2]);
          fma4(acc[r], cv.w, sv[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int i = ty + r * TR;
      if (i < c) store4(y + (t0 + i) * xrow + h * P + 4 * tx, acc[r]);
    }
    __syncthreads();                      // C and the old state are no longer read

    // 6. w_j B_j into the work buffer
    for (int e = tid; e < c * N4; e += NT) {
      const int i = e / N4;
      const int q = e % N4;
      store4(ws + i * ldc + q * 4, scale4(load4(Bm + (t0 + i) * N + q * 4), wj[i]));
    }
    __syncthreads();

    // 7. state[n][p] = exp(cum_last) state[n][p] + sum_j (w_j B_j)[n] x_j[p],
    //    rows n = ty + r * TR, columns 4 tx .. 4 tx + 3
    const float dl = expf(cum_last);
    float4 sacc[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int n = ty + r * TR;
      sacc[r] = n < N ? scale4(*reinterpret_cast<const float4*>(ss + n * lds + 4 * tx), dl)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j = 0; j < c; ++j) {
      const float4 xv = reinterpret_cast<const float4*>(xs)[j * P4 + tx];
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int n = ty + r * TR;
        if (n < N) fma4(sacc[r], ws[j * ldc + n], xv);
      }
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int n = ty + r * TR;
      if (n < N) *reinterpret_cast<float4*>(ss + n * lds + 4 * tx) = sacc[r];
    }
    __syncthreads();                      // the next chunk overwrites xs and ws
  }

  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N;
    const int n = e % N;
    final_state[st_off + e] = ss[n * lds + p];
  }
}

// ---------------------------------------------------------------------------
// bf16 x and bf16 B/C: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 256;      // threads (8 warps) per tensor-core scan CTA

__host__ __device__ __forceinline__ int ceil16(int v) { return (v + 15) & ~15; }

// Shared memory of the tensor-core scan CTA in bytes (cp = chunk and np = N
// rounded up to 16): C and B of one chunk (cp x (np + 8) bf16 each), x in
// two stages (cp x (PS + 8) bf16 each), the state as bf16 hi and lo parts
// (PS x (np + 8) each), then dt in two stages, cum, e^cum and w (cp f32 each).
__host__ __device__ __forceinline__ int mma_smem_bytes(int PS, int N, int c) {
  const int cp = ceil16(c);
  const int ldn = ceil16(N) + 8;
  return 2 * (2 * cp * ldn + 2 * cp * (PS + 8) + 2 * PS * ldn) + 4 * 5 * cp;
}

template <int PS>
__global__ void __launch_bounds__(MMA_NT, 2)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ init_state,
               __nv_bfloat16* __restrict__ y, float* __restrict__ final_state, int S, int H,
               int P, int N, int c) {
  constexpr int NTP = PS / 8;          // n-tiles of the slice's P columns
  const int cp = ceil16(c);
  const int np = ceil16(N);
  const int ldn = np + 8;              // row stride of C, B and the state (16 B of skew)
  constexpr int ldx = PS + 8;          // row stride of x
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // cp x ldn, [i][n]
  __nv_bfloat16* sB = sC + cp * ldn;                                // cp x ldn, [j][n]
  __nv_bfloat16* sX = sB + cp * ldn;                                // 2 x cp x ldx, [j][p]
  __nv_bfloat16* sSh = sX + 2 * cp * ldx;                           // PS x ldn, [p][n]
  __nv_bfloat16* sSl = sSh + PS * ldn;
  float* sDt = reinterpret_cast<float*>(sSl + PS * ldn);            // 2 x cp
  float* sCum = sDt + 2 * cp;
  float* sEcum = sCum + cp;                                         // e^cum_i
  float* sW = sEcum + cp;                                           // e^(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int slices = P / PS;
  const int bh = blockIdx.x / slices;
  const int ps = blockIdx.x % slices;
  const int b = bh / H;
  const int h = bh % H;
  const int nc = S / c;
  const float a = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;        // x / y stride between positions
  const int pcol = h * P + ps * PS;                      // the slice's first column in a row
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * N + static_cast<size_t>(ps) * PS * N;

  // Zero everything once: the padding rows (c..cp) and columns (N..np) are
  // never written by a copy, so they stay zero for the whole scan.
  {
    uint4* s4 = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = mma_smem_bytes(PS, N, c) / 16;
    for (int i = tid; i < n16; i += MMA_NT) s4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  auto load_x = [&](int z, int stage) {
    const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(z) * c;
    __nv_bfloat16* dx = sX + stage * cp * ldx;
    for (int i = tid; i < c * NTP; i += MMA_NT) {
      const int r = i / NTP;
      const int q = (i % NTP) * 8;
      mma::cp_async16(dx + r * ldx + q, x + (t0 + r) * xrow + pcol + q, true);
    }
    float* dd = sDt + stage * cp;
    for (int i = tid; i < c; i += MMA_NT) mma::cp_async4(dd + i, dt + (t0 + i) * H + h);
  };
  auto load_bc = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int z) {
    const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(z) * c;
    if ((N & 7) == 0) {
      const int cpr = N / 8;
      for (int i = tid; i < c * cpr; i += MMA_NT) {
        const int r = i / cpr;
        const int q = (i % cpr) * 8;
        mma::cp_async16(dst + r * ldn + q, src + (t0 + r) * N + q, true);
      }
    } else {                                   // N a multiple of 4: 8-byte copies
      const int cpr = N / 4;
      for (int i = tid; i < c * cpr; i += MMA_NT) {
        const int r = i / cpr;
        const int q = (i % cpr) * 4;
        mma::cp_async8(dst + r * ldn + q, src + (t0 + r) * N + q);
      }
    }
  };

  // The state (P-slice x N, f32) lives in registers as mma accumulators:
  // warp w owns state rows n = 16w .. 16w + 15 (the m axis) and every p.
  const bool owns_state = warp < np / 16;
  const int n_a = warp * 16 + g;             // this lane's state rows n_a and n_a + 8
  float st[NTP][4];
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n_a + (e >> 1) * 8;
      const int p = nt * 8 + 2 * t4 + (e & 1);
      st[nt][e] = (owns_state && init_state != nullptr && n < N) ? init_state[st_off + p * N + n]
                                                                 : 0.f;
    }
  }
  // The state as bf16 hi + lo parts, [p][n], the B operand of C . state^T.
  auto store_state = [&]() {
    if (!owns_state) return;
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n_a + (e >> 1) * 8;
        const int p = nt * 8 + 2 * t4 + (e & 1);
        const __nv_bfloat16 hi = __float2bfloat16(st[nt][e]);
        sSh[p * ldn + n] = hi;
        sSl[p * ldn + n] = __float2bfloat16(st[nt][e] - __bfloat162float(hi));
      }
    }
  };

  store_state();
  load_x(0, 0);
  load_bc(sC, Cm, 0);
  load_bc(sB, Bm, 0);
  mma::cp_async_commit();

  for (int z = 0; z < nc; ++z) {
    const int stage = z & 1;
    const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(z) * c;
    if (z + 1 < nc) load_x(z + 1, stage ^ 1);   // overlaps this chunk's products
    mma::cp_async_commit();
    mma::cp_async_wait<1>();                     // this chunk's x, dt, C and B have landed
    __syncthreads();                             // (1)

    // 1. warp 0: cum = cumsum(dt a) by a warp scan (4 positions a lane), then
    //    e^cum and w_j = e^(cum_last - cum_j) dt_j; padding positions have dt = 0.
    const float* dts = sDt + stage * cp;
    if (warp == 0) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        run += i < cp ? dts[i] * a : 0.f;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += u;
      }
      const float base = tot - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < cp) sCum[i] = base + v[k];
      }
      __syncwarp();
      const float last = sCum[c - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < cp) {
          sEcum[i] = expf(sCum[i]);
          sW[i] = expf(last - sCum[i]) * dts[i];
        }
      }
    }

    // 2. y_off = C . state^T for rows 16w .. 16w + 15 (needs no cum, so it
    //    runs beside the scan): A = C (exact bf16), B = the state hi + lo.
    const int i0 = warp * 16;
    const bool owns_rows = warp < cp / 16;
    float acc[NTP][4];
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (owns_rows) {
      for (int kk = 0; kk < np / 16; ++kk) {
        uint32_t af[4];
        mma::ldmatrix_x4(af, sC + (i0 + (lane & 15)) * ldn + kk * 16 + (lane >> 4) * 8);
        if constexpr (NTP >= 2) {
#pragma unroll
          for (int pp = 0; pp < NTP / 2; ++pp) {
            const int off = (pp * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            mma::ldmatrix_x4(bh, sSh + off);
            mma::ldmatrix_x4(bl, sSl + off);
            mma::mma_bf16(acc[2 * pp], af, bh[0], bh[1]);
            mma::mma_bf16(acc[2 * pp], af, bl[0], bl[1]);
            mma::mma_bf16(acc[2 * pp + 1], af, bh[2], bh[3]);
            mma::mma_bf16(acc[2 * pp + 1], af, bl[2], bl[3]);
          }
        } else {
          const int off = (lane & 7) * ldn + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bh[2], bl[2];
          mma::ldmatrix_x2(bh, sSh + off);
          mma::ldmatrix_x2(bl, sSl + off);
          mma::mma_bf16(acc[0], af, bh[0], bh[1]);
          mma::mma_bf16(acc[0], af, bl[0], bl[1]);
        }
      }
    }
    __syncthreads();                             // (2) cum, e^cum and w are in place

    const __nv_bfloat16* xs = sX + stage * cp * ldx;
    if (owns_rows) {
      // 3. y = e^cum_i y_off + L X over the column tiles on or below the
      //    diagonal. Per 16 x 16 tile, C . B^T comes from the tensor cores
      //    (exact bf16 inputs, f32 sums) straight into the accumulator layout
      //    that is also the A fragment layout; then L[i][j] = CB[i][j]
      //    e^(cum_i - cum_j) dt_j for j <= i < c, else 0 (masked before the
      //    exp: above the diagonal cum_i - cum_j can overflow), split into
      //    bf16 hi + lo.
      const int ia = i0 + g;
      const int ib = ia + 8;
      const float ea = sEcum[ia];
      const float eb = sEcum[ib];
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        acc[nt][0] *= ea; acc[nt][1] *= ea;
        acc[nt][2] *= eb; acc[nt][3] *= eb;
      }
      const float cum_a = sCum[ia];
      const float cum_b = sCum[ib];
      for (int jt = 0; jt <= warp; ++jt) {
        const int j0 = jt * 16;
        float cbv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < np / 16; ++kk) {
          uint32_t af[4], bf[4];
          mma::ldmatrix_x4(af, sC + (i0 + (lane & 15)) * ldn + kk * 16 + (lane >> 4) * 8);
          mma::ldmatrix_x4(bf, sB + (j0 + (lane & 7) + (lane >> 4) * 8) * ldn + kk * 16 +
                                   ((lane >> 3) & 1) * 8);
          mma::mma_bf16(cbv[0], af, bf[0], bf[1]);
          mma::mma_bf16(cbv[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
            cbv[nt][e] = (j <= i && i < c)
                ? cbv[nt][e] * __expf((e < 2 ? cum_a : cum_b) - sCum[j]) * dts[j] : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        mma::split_bf16(cbv[0][0], cbv[0][1], ah[0], al[0]);
        mma::split_bf16(cbv[0][2], cbv[0][3], ah[1], al[1]);
        mma::split_bf16(cbv[1][0], cbv[1][1], ah[2], al[2]);
        mma::split_bf16(cbv[1][2], cbv[1][3], ah[3], al[3]);
        const __nv_bfloat16* xr = xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx;
        if constexpr (NTP >= 2) {
#pragma unroll
          for (int pp = 0; pp < NTP / 2; ++pp) {
            uint32_t r[4];
            mma::ldmatrix_x4_trans(r, xr + pp * 16 + (lane >> 4) * 8);
            mma::mma_bf16(acc[2 * pp], ah, r[0], r[1]);
            mma::mma_bf16(acc[2 * pp], al, r[0], r[1]);
            mma::mma_bf16(acc[2 * pp + 1], ah, r[2], r[3]);
            mma::mma_bf16(acc[2 * pp + 1], al, r[2], r[3]);
          }
        } else {
          uint32_t r[2];
          mma::ldmatrix_x2_trans(r, xr);
          mma::mma_bf16(acc[0], ah, r[0], r[1]);
          mma::mma_bf16(acc[0], al, r[0], r[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        const int col = pcol + nt * 8 + 2 * t4;
        if (ia < c)
          *reinterpret_cast<uint32_t*>(y + (t0 + ia) * xrow + col) =
              mma::pack_bf16(acc[nt][0], acc[nt][1]);
        if (ib < c)
          *reinterpret_cast<uint32_t*>(y + (t0 + ib) * xrow + col) =
              mma::pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }

    // 4. state = e^cum_last state + B^T (w X), in registers: A = B^T (exact
    //    bf16, ldmatrix.trans), B operand = w_j x_j (f32, split into bf16
    //    hi + lo in registers). A warp goes on from its rows of y without
    //    waiting for the others.
    if (owns_state) {
      const float dl = expf(sCum[c - 1]);
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        st[nt][0] *= dl; st[nt][1] *= dl; st[nt][2] *= dl; st[nt][3] *= dl;
      }
      const int n0 = warp * 16;
      for (int jt = 0; jt < cp / 16; ++jt) {
        const int j0 = jt * 16;
        uint32_t af[4];
        mma::ldmatrix_x4_trans(af, sB + (j0 + (lane & 7) + (lane >> 4) * 8) * ldn + n0 +
                                       ((lane >> 3) & 1) * 8);
        const float w0 = sW[j0 + 2 * t4];
        const float w1 = sW[j0 + 2 * t4 + 1];
        const float w8 = sW[j0 + 2 * t4 + 8];
        const float w9 = sW[j0 + 2 * t4 + 9];
        const __nv_bfloat16* xr = xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx;
        auto scaled = [&](uint32_t lo_k, uint32_t hi_k, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
          const float2 u = mma::unpack_bf16(lo_k);     // rows j0 + 2t, j0 + 2t + 1
          const float2 v = mma::unpack_bf16(hi_k);     // rows j0 + 2t + 8, j0 + 2t + 9
          mma::split_bf16(u.x * w0, u.y * w1, bh[0], bl[0]);
          mma::split_bf16(v.x * w8, v.y * w9, bh[1], bl[1]);
        };
        if constexpr (NTP >= 2) {
#pragma unroll
          for (int pp = 0; pp < NTP / 2; ++pp) {
            uint32_t r[4];
            mma::ldmatrix_x4_trans(r, xr + pp * 16 + (lane >> 4) * 8);
            uint32_t bh[2], bl[2];
            scaled(r[0], r[1], bh, bl);
            mma::mma_bf16(st[2 * pp], af, bh[0], bh[1]);
            mma::mma_bf16(st[2 * pp], af, bl[0], bl[1]);
            scaled(r[2], r[3], bh, bl);
            mma::mma_bf16(st[2 * pp + 1], af, bh[0], bh[1]);
            mma::mma_bf16(st[2 * pp + 1], af, bl[0], bl[1]);
          }
        } else {
          uint32_t r[2];
          mma::ldmatrix_x2_trans(r, xr);
          uint32_t bh[2], bl[2];
          scaled(r[0], r[1], bh, bl);
          mma::mma_bf16(st[0], af, bh[0], bh[1]);
          mma::mma_bf16(st[0], af, bl[0], bl[1]);
        }
      }
    }
    __syncthreads();                  // (3) C, B, this stage of x and the old state are read
    store_state();                    // visible to the next chunk after its barrier (1)
    if (z + 1 < nc) {
      load_bc(sC, Cm, z + 1);
      load_bc(sB, Bm, z + 1);
    }
    mma::cp_async_commit();
  }

  if (owns_state) {
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n_a + (e >> 1) * 8;
        const int p = nt * 8 + 2 * t4 + (e & 1);
        if (n < N) final_state[st_off + p * N + n] = st[nt][e];
      }
    }
  }
}

template <typename TX, typename TBC, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* init_state, void* cb, void* y,
                   void* final_state, int batch, int S, int H, int N, int chunk,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<TX, __nv_bfloat16> && std::is_same_v<TBC, __nv_bfloat16>) {
    constexpr int PS = P == 8 ? 8 : P / 2;      // columns of P per CTA
    const int smem = mma_smem_bytes(PS, N, chunk);
    auto kernel = ssd_mma_kernel<PS>;
    static std::atomic<unsigned long long> configured{0};
    const cudaError_t err =
        mma::set_smem_once(kernel, mma_smem_bytes(PS, MAX_CHUNK, MAX_CHUNK), configured);
    if (err != cudaSuccess) return err;
    kernel<<<batch * H * (P / PS), MMA_NT, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const TBC*>(B),
        static_cast<const TBC*>(C), static_cast<const float*>(init_state),
        static_cast<TX*>(y), static_cast<float*>(final_state), S, H, P, N, chunk);
  } else {
    if (cb == nullptr) return cudaErrorInvalidValue;
    const int nc = S / chunk;
    const int tiles = (chunk + CB_TILE - 1) / CB_TILE;
    cb_kernel<TBC><<<dim3(batch * nc, tiles, tiles), dim3(CB_TILE, 8), 0, stream>>>(
        static_cast<const TBC*>(C), static_cast<const TBC*>(B), static_cast<float*>(cb),
        S, N, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(P, N, chunk));
    auto kernel = ssd_scan_kernel<TX, TBC, P>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<batch * H, NT, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const TBC*>(B),
        static_cast<const TBC*>(C), static_cast<const float*>(cb),
        static_cast<const float*>(init_state), static_cast<TX*>(y),
        static_cast<float*>(final_state), S, H, N, chunk);
  }
  return cudaGetLastError();
}

template <typename TX, typename TBC>
cudaError_t dispatch_p(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* init_state, void* cb, void* y,
                       void* final_state, int batch, int S, int H, int P, int N,
                       int chunk, cudaStream_t stream) {
  switch (P) {
    case 8: return launch<TX, TBC, 8>(x, dt, A, B, C, init_state, cb, y, final_state,
                                      batch, S, H, N, chunk, stream);
    case 16: return launch<TX, TBC, 16>(x, dt, A, B, C, init_state, cb, y, final_state,
                                        batch, S, H, N, chunk, stream);
    case 32: return launch<TX, TBC, 32>(x, dt, A, B, C, init_state, cb, y, final_state,
                                        batch, S, H, N, chunk, stream);
    case 64: return launch<TX, TBC, 64>(x, dt, A, B, C, init_state, cb, y, final_state,
                                        batch, S, H, N, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: contiguous (batch, S, H, P), float32 (x_bf16 = 0) or bfloat16 (1);
// dt: (batch, S, H) f32; A: (H,) f32; B, C: contiguous (batch, S, N), both
// float32 (bc_bf16 = 0) or both bfloat16 (1); init_state: (batch, H, P, N)
// f32 or null (zero state); cb: f32 scratch of batch * S * chunk floats
// for the scalar kernel (any f32 operand), unused (may be null) when x and
// B/C are both bf16;
// final_state: (batch, H, P, N) f32. All 16-byte aligned. P in {8, 16, 32,
// 64}, N a multiple of 4 in [4, 128], chunk in [1, 128] dividing S.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int k2_ssd_scan(const void* x, const void* dt, const void* A,
                           const void* B, const void* C, const void* init_state,
                           void* cb, void* y, void* final_state, int batch, int S,
                           int H, int P, int N, int chunk, int x_bf16, int bc_bf16,
                           void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > MAX_CHUNK || S % chunk != 0 ||
      N < 4 || N > MAX_CHUNK || N % 4 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return bc_bf16
        ? dispatch_p<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, init_state, cb, y,
                                                   final_state, batch, S, H, P, N, chunk, st)
        : dispatch_p<__nv_bfloat16, float>(x, dt, A, B, C, init_state, cb, y,
                                           final_state, batch, S, H, P, N, chunk, st);
  }
  return bc_bf16
      ? dispatch_p<float, __nv_bfloat16>(x, dt, A, B, C, init_state, cb, y, final_state,
                                         batch, S, H, P, N, chunk, st)
      : dispatch_p<float, float>(x, dt, A, B, C, init_state, cb, y, final_state, batch,
                                 S, H, P, N, chunk, st);
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
