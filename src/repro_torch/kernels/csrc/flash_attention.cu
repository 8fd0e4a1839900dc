// K1: flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention() there). Same function: q (B, S, H, hd),
// k and v (B, T, K, hd) with H % K == 0 -> o (B, S, H, hd); query head h
// reads KV head h / (H / K), the reference's repeat_kv mapping, so K == H
// is the reference's full-H call and K < H reads grouped (GQA) k/v as the
// model projects it, with no repeated copy. Scale 1/sqrt(hd), causal mask
// -1e30 (query i sees keys j <= q_off + i), online softmax with f32 running m / l
// / acc, l clamped to >= 1e-30, output rounded to the input dtype. Beyond
// the Pallas kernel's domain, any S and T work: the ragged edge is masked
// here instead of asserting block divisibility. hd is 32, 64, 128 or 256
// (the Pallas kernel's note gives 64..256 for the assigned archs; gemma-7b
// has 256). q_off makes local query row i global row q_off + i of the
// causal mask: one rank's block of rows under q-sequence tensor
// parallelism, against the full K/V (0 = the unsharded call). It moves
// the causal bound, the skip of dead tiles and the mask alike.
//
// bf16 design (flash_mma_kernel, the serving path):
//   * one CTA of 4 warps per (b * h, 64-row q tile), each warp owning 16
//     query rows; q tiles are scheduled heaviest first;
//   * the q tile is copied to shared memory once and kept in registers as
//     mma A fragments (ldmatrix);
//   * K and V tiles of 64 keys are copied as bf16 by cp.async into a
//     two-stage ring, the next tile's copy overlapping this tile's math;
//     rows past T are zero-filled by the copy;
//   * S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); V's B fragments come from ldmatrix.trans;
//   * the online softmax runs on the S accumulator fragments: a row's max
//     is reduced over its quad of lanes with shuffles, each lane keeps a
//     partial row sum (reduced once at the end), and P is rounded to bf16
//     in registers to feed P V. That rounding departs from the reference,
//     which forms p v in f32; FA2 and PyTorch's SDPA do the same (PERF.md
//     gives the measured error);
//   * one barrier per tile: the copy of the next tile is issued right after
//     it, into the stage that every warp has just finished reading;
//   * causally dead tiles are never loaded (the CTA stops at its last
//     visible key), a warp skips a tile that lies wholly after its rows,
//     and only tiles that cross the diagonal or the ragged edge are masked;
//   * the softmax works in base 2 (scale * log2 e folded into one multiply,
//     2^x on the special-function unit); the -1e30 mask value is kept;
//   * the output goes through shared memory to 16-byte stores;
//   * at hd 256 the O accumulator alone takes 128 registers a thread, so
//     the kernel takes 32-key tiles (16 score registers, not 32) and reads
//     q's A fragments from shared memory at each k-step instead of holding
//     all 64 of their registers (sQ holds the tile for the whole loop):
//     (64 + 4 * 32) rows * 264 * 2 B = 101,376 B of shared memory, two
//     CTAs to an SM.
// One CTA per (b * h) q tile rather than per KV head: the G query heads of
// one KV head read the same K/V tiles, which stay in the 50 MB L2. Measured
// on the H100 and slower (PERF.md): 128 packed (position, head) rows of one
// KV head per CTA, two m-tiles per warp, 8-warp CTAs, a three-stage ring,
// 32-key tiles, a register cap of 128, skipping masked key groups on the
// diagonal, and folding the scale into the exponent's FMA.
//
// f32 design (flash_fwd_kernel: the consistency checks only): the scalar
// kernel of the first port, unchanged apart from reading K-head k/v. Each
// query row is owned by HD/32 threads holding q and acc in registers; K
// and V tiles are staged in shared memory as f32; scalar FMAs. Its 1e-5
// tolerance is out of reach of TF32 tensor cores.
//
// Bound at the serving shape of qwen2-0.5b (B=8, S=T=512, H=14, K=2,
// hd=64, bf16, causal): 4*B*H*hd*S(S+1)/2 = 3.77 GFLOP, 3.8 us at the bf16
// tensor rate of 989 TFLOP/s; q and o are 2 * 7.34 MB, k and v 2 * 1.05 MB
// (K = 2 heads), 16.8 MB together, 5.0 us at 3.35 TB/s. So it is bound by
// bytes near 5 us per launch. At gemma-7b's prefill shape (B=8, S=T=512,
// H=K=16, hd=256, bf16, causal): 17.2 GFLOP, 17.4 us; q, k, v and o
// 4 * 33.6 MB, 40.1 us: bound by bytes too. mma.sync reaches well under
// the 989 TFLOP/s of wgmma; wgmma, TMA and warp specialisation are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;             // query rows per CTA (f32 kernel)
constexpr int KC = 16;             // keys per online-softmax step (f32 kernel)
constexpr int TILE_FLOATS = 4096;  // f32 values per staged K (and V) tile (f32 kernel)
constexpr int MMA_THREADS = 128;   // bf16 kernel: 4 warps of 16 query rows,
constexpr int MMA_BQ = 64;         // so 64 query rows per CTA,
constexpr int BK_WIDE = 32;        // keys per K/V tile at hd 256 (64 below it)
constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (the softmax works in base 2: e^x = 2^(x log2 e)).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// Keys per K/V tile, and whether q's fragments stay in registers for the
// whole loop (else they are read from sQ at each k-step): see the note.
template <int HD>
__host__ __device__ constexpr int kv_tile() {
  return HD <= 128 ? 64 : BK_WIDE;
}

template <int HD>
__host__ __device__ constexpr bool q_in_registers() {
  return HD <= 128;
}

template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (MMA_BQ + 4 * kv_tile<HD>()) * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int S, int Tk, int H, int K, float scale, int causal, int q_off) {
  constexpr int BK = kv_tile<HD>();
  constexpr bool QREG = q_in_registers<HD>();
  constexpr int LD = HD + 8;     // shared row stride in elements: 16 B of skew per row
  constexpr int CPR = HD / 8;    // 16-byte chunks per row
  constexpr int NTK = BK / 8;    // key n-tiles of S
  constexpr int NTD = HD / 8;    // head-dim n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // MMA_BQ x LD
  __nv_bfloat16* sK = sQ + MMA_BQ * LD;                              // 2 stages of BK x LD
  __nv_bfloat16* sV = sK + 2 * BK * LD;                              // 2 stages of BK x LD

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;   // heaviest tile first
  const int row0 = q0 + warp * 16;                        // this warp's first query row
  const int grow0 = q_off + row0;                         // ... as a row of the causal mask
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Tk * K + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Tk * K + kvh) * HD;

  for (int i = tid; i < MMA_BQ * CPR; i += MMA_THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = q0 + r < S;
    mma::cp_async16(sQ + r * LD + c, ok ? qb + (q0 + r) * q_stride + c : qb, ok);
  }
  auto load_kv = [&](int stage, int k0) {
    __nv_bfloat16* dk = sK + stage * BK * LD;
    __nv_bfloat16* dv = sV + stage * BK * LD;
    for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
      const int r = i / CPR;
      const int c = (i % CPR) * 8;
      const bool ok = k0 + r < Tk;
      const size_t off = ok ? (k0 + r) * kv_stride + c : 0;
      mma::cp_async16(dk + r * LD + c, kb + off, ok);
      mma::cp_async16(dv + r * LD + c, vb + off, ok);
    }
  };

  const int kv_end = causal ? min(Tk, q_off + q0 + MMA_BQ) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_kv(0, 0);
  mma::cp_async_commit();

  uint32_t qf[QREG ? HD / 16 : 1][4];
  float acc[NTD][4];
#pragma unroll
  for (int d = 0; d < NTD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running row max of the scores in base-2 units
  float lsum[2] = {0.f, 0.f};        // this lane's share of each row's sum
  const float scale2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    mma::cp_async_wait<0>();   // this tile (and, at first, q) has landed for this thread,
    __syncthreads();           // for every thread; and every warp is done with the
                               // previous tile, whose stage the next copy reuses
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, k0 + BK);
      mma::cp_async_commit();
    }
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma::ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    if (causal && k0 > grow0 + 15) continue;  // warp-uniform: all its rows precede the tile
    const __nv_bfloat16* tk = sK + (it & 1) * BK * LD;
    const __nv_bfloat16* tv = sV + (it & 1) * BK * LD;

    // S = Q K^T
    float s[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        mma::ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NTK / 2; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, tk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], a, r[0], r[1]);
        mma::mma_bf16(s[2 * np + 1], a, r[2], r[3]);
      }
    }

    // scale (to base 2), mask (only tiles crossing the diagonal or the
    // ragged edge), online softmax
    const bool masked = (k0 + BK > Tk) || (causal && k0 + BK - 1 > grow0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (masked) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = grow0 + g + (e >> 1) * 8;
          if (key >= Tk) x = -INFINITY;                 // past the ragged edge
          else if (causal && key > row) x = NEG_INF;    // the reference's mask
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      lsum[r] *= corr[r];
    }
#pragma unroll
    for (int d = 0; d < NTD; ++d) {
      acc[d][0] *= corr[0]; acc[d][1] *= corr[0];
      acc[d][2] *= corr[1]; acc[d][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[n][e] - m[e >> 1]);
        lsum[e >> 1] += p;
        s[n][e] = p;
      }
    }

    // O += P V, P rounded to bf16 in registers (the S fragments are P's A fragments)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NTD / 2; ++dp) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dp], a, r[0], r[1]);
        mma::mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30), through this warp's rows of sQ to 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lsum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* so = sQ + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < NTD; ++d) {
    *reinterpret_cast<uint32_t*>(so + g * LD + d * 8 + 2 * t4) =
        mma::pack_bf16(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + d * 8 + 2 * t4) =
        mma::pack_bf16(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * S * H + h) * HD;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(so + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int HD>
__global__ void __launch_bounds__(BQ * (HD / 32))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int S, int Tk, int H, int K, float scale, int causal, int q_off) {
  constexpr int TPR = HD / 32;   // threads per query row
  constexpr int NT = BQ * TPR;   // threads per CTA
  constexpr int C4 = HD / 4;     // float4 columns per row
  constexpr int NC = C4 / TPR;   // float4 columns per thread (8)
  constexpr int BKF = TILE_FLOATS / HD;  // kv rows per staged tile

  __shared__ float4 ks[TILE_FLOATS / 4];
  __shared__ float4 vs[TILE_FLOATS / 4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;    // this thread owns columns c * TPR + part
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int qi = q0 + row;
  const size_t row_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const float* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<size_t>(b) * Tk * K + kvh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * Tk * K + kvh) * HD;

  float4 qr[NC];
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = qi < S ? load4(qb + qi * row_stride + (c * TPR + part) * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF;
  float l = 0.f;

  const int kv_end = causal ? min(Tk, q_off + q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BKF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BKF * C4; i += NT) {
      const int t = k0 + i / C4;
      const int col = (i % C4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (t < Tk) {
        kk = load4(kb + t * kv_stride + col);
        vv = load4(vb + t * kv_stride + col);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    const int tile_end = min(BKF, kv_end - k0);
    for (int j0 = 0; j0 < tile_end; j0 += KC) {
      float s[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 qv = qr[c];
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float4 kv = ks[(j0 + j) * C4 + c * TPR + part];
          s[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        const int t = k0 + j0 + j;
        float x = s[j] * scale;
        if (t >= Tk) x = -INFINITY;                 // past the ragged edge
        else if (causal && t > q_off + qi) x = NEG_INF;   // the reference's mask
        s[j] = x;
        m_new = fmaxf(m_new, x);
      }
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = vs[(j0 + j) * C4 + c * TPR + part];
          acc[c].x += p * vv.x; acc[c].y += p * vv.y;
          acc[c].z += p * vv.z; acc[c].w += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (qi < S) {
    const float lc = fmaxf(l, 1e-30f);
    float* ob = o + (static_cast<size_t>(b) * S * H + h) * HD + qi * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store4(ob + (c * TPR + part) * 4,
             make_float4(acc[c].x / lc, acc[c].y / lc, acc[c].z / lc, acc[c].w / lc));
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int Tk, int H, int K, int is_bf16, int causal, int q_off,
                   cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  if (is_bf16) {
    const dim3 grid(B * H, (S + MMA_BQ - 1) / MMA_BQ);
    constexpr int smem = mma_smem_bytes<HD>();
    auto kernel = flash_mma_kernel<HD>;
    static std::atomic<unsigned long long> configured{0};
    const cudaError_t err = mma::set_smem_once(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    kernel<<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Tk, H, K,
        scale, causal, q_off);
  } else {
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    flash_fwd_kernel<HD><<<grid, BQ * (HD / 32), 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, K, scale, causal,
        q_off);
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: contiguous (B, S, H, hd); k, v: contiguous (B, Tk, K, hd) with
// H % K == 0; all 16-byte aligned device arrays, all float32 (is_bf16 = 0)
// or all bfloat16 (is_bf16 = 1); hd in {32, 64, 128, 256}; q_off >= 0 the
// global row of q's first row in the causal mask. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (0 = launched).
extern "C" int k1_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int Tk, int H, int K, int hd,
                                      int is_bf16, int causal, int q_off, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || K <= 0 || H % K != 0 || q_off < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 64: return launch<64>(q, k, v, o, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 128: return launch<128>(q, k, v, o, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 256: return launch<256>(q, k, v, o, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
