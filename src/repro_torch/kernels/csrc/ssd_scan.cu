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
// both) may be f32 or bf16 independently of x. All arithmetic is f32.
//
// Design (simple and right first):
//   * Two kernels per call. cb_kernel computes C . B^T once per
//     (batch, chunk) into an f32 scratch (b, n_chunks, c, c) that the
//     wrapper allocates: with n_groups = 1, B and C carry no head axis, so
//     a per-head CTA that formed the (c, c) product itself would repeat it
//     once per head (80x at mamba2-2.7b, 10.7 GFLOP more per call). Only the
//     32x32 tiles on or below the diagonal are computed; the scan reads no
//     other entry.
//   * ssd_scan_kernel: one CTA per (batch, head). Hopper blocks run in no
//     order, so the TPU's sequential chunk axis (its grid axis 1, with the
//     state in VMEM scratch) becomes a loop over chunks inside the CTA,
//     which owns its (P, N) state in shared memory (32 KB of f32 at P=64,
//     N=128, stored [n][p]). At the serving shape that is 8 * 80 = 640 CTAs
//     on 132 SMs; the CTAs of one batch row are adjacent, so their shared
//     C, B and C . B^T stay in L2.
//   * Per chunk, three register-tiled f32 products over shared memory,
//     each thread owning 4 adjacent columns of P and P/8 strided rows:
//     y = L X with L = C . B^T * exp(cum_i - cum_j) * dt_j (built only for
//     j <= i: cum falls along the chunk, so exp(cum_i - cum_j) above the
//     diagonal can overflow to inf, and inf * 0 is NaN; the mask is applied
//     before the exp); y += (exp(cum) C) . state^T; and the state update
//     state = exp(cum_last) state + (w B)^T X with w_j = exp(cum_last -
//     cum_j) dt_j. One work buffer holds L, then C, then B.
//   * Any chunk from 1 to 128 that divides s (96 for s = 96, 12 for s = 24,
//     1 for a prime s), any N that is a multiple of 4 up to 128, and P in
//     {8, 16, 32, 64}. Shared memory is dynamic (137 KB at c = 128, P = 64,
//     N = 128), so one CTA of 256 threads runs per SM.
//
// Bound at the serving shape of mamba2-2.7b (b=8, s=512, h=80, p=64, n=128,
// bf16 x/B/C, f32 dt and state): bytes x 41.9 MB + y 41.9 MB + dt 1.3 MB +
// B, C 2.1 MB + final state 21.0 MB = 108 MB, 32 us at 3.35 TB/s; about
// 13.5 GFLOP of multiply-adds, 14 us at bf16's 989 TFLOP/s. So it is
// bytes-bound near 32 us per launch. This kernel does its products as
// scalar f32 FMAs (no tensor cores), whose 67 TFLOP/s put its own floor
// near 200 us; tensor-core tiles (mma.sync / wgmma), TMA loads that
// overlap the products, and skipping the zero upper half of L are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

template <typename TX, typename TBC, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* init_state, void* cb, void* y,
                   void* final_state, int batch, int S, int H, int N, int chunk,
                   cudaStream_t stream) {
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
// f32 or null (zero state); cb: f32 scratch of batch * S * chunk floats;
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
