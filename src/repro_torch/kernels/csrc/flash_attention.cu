// K1: flash attention forward and its backward, hand-written for Hopper (sm_90a).
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
// Under a gradient flash_mma_kernel also writes each row's log-sum-exp of
// the scaled scores, (m + log2 l) ln 2 in f32, (B, H, S), for the backward;
// without one (prefill, decode, eval) it gets a null pointer and writes none.
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

// Backward (k1_bwd_dq_kernel, k1_bwd_dkdv_kernel, k1_bwd_gsum_kernel; bf16,
// hd 32, 64 and 128). It replaces no TPU kernel: the Pallas K1 is
// forward-only and the JAX model trains through XLA's autodiff of its jnp
// attention, which runs bf16 products. The port's first backward was
// tensor ops (kernels/ref.py::attention_bwd): the whole (B, H, S, T)
// score, P, dP and dS in f32, k and v copied to every head, f32 GEMMs over
// the masked triangle too; at qwen2-1.5b's train shape (B=4, S=T=2048,
// H=12, K=2, hd 128, causal) 10.1 ms a layer, 41% of the train step. This
// is the same mathematics as XLA's bf16 autodiff: bf16 operands, f32
// accumulation, P and dS rounded to bf16 only to feed the tensor cores.
//   dV = P^T dO, dP = dO V^T, dS = P (dP - delta), delta = rowsum(dO O),
//   dQ = scale dS K, dK = scale dS^T Q, P = 2^(S scale log2 e - lse log2 e).
// Bound at that shape: the five products (S again, dV, dP, dQ, dK) over
// the live pairs are 10 hd FLOPs a pair, 1.29e11 a layer: 0.130 ms at 989
// TFLOP/s (3.65 ms a step of 28 layers); bytes (q, o, dO, dq 4 x 25 MB, k,
// v, dk, dv 4 x 4 MB) 0.035 ms. So it is bound by operations. The design:
//   * two passes, each shaped like the forward (4 warps of 16 rows, 64-row
//     tiles, mma.sync.m16n8k16 with ldmatrix / ldmatrix.trans fragments, a
//     two-stage cp.async ring, dead tiles skipped, masks only on tiles that
//     cross the diagonal or a ragged edge, base-2 exponents);
//   * k1_bwd_dq_kernel: a CTA per (b * h, q tile), heaviest first, walks the
//     key tiles its rows see: S = Q K^T and dP = dO V^T from the saved
//     log-sum-exp, dQ += dS K in registers. It also computes delta from o
//     and dO while its first copies fly, and writes each row's base-2
//     log-sum-exp and delta, padded to 64 rows (+inf and 0 past S, so P is
//     0 there), for the second pass;
//   * k1_bwd_dkdv_kernel: a CTA per (b * h, key tile), heaviest (first)
//     first, walks the q tiles that see its keys, from the diagonal on. It
//     computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so that
//     P^T and dS^T come out of the accumulators as the A fragments of
//     dV += P^T dO and dK += dS^T Q, with no trip through shared memory;
//     dK and dV stay in f32 registers (128 a thread at hd 128);
//   * dQ is deterministic by construction: the separate pass over q tiles
//     recomputes S and dP (seven products where five are the minimum, 1.4x
//     the operations) instead of float atomics, whose order changes from
//     run to run. Two backwards are bit-equal;
//   * GQA: a CTA per query head (not per KV head looping over its G heads:
//     under the causal mask the first key tiles carry 32x the last's work,
//     and 256 such CTAs at the train shape balance poorly on 132 SMs), so
//     dK and dV of a KV head's G heads are written as f32 partials (B, T,
//     H, hd) and k1_bwd_gsum_kernel sums them in head order (50 + 50 MB
//     written and read at the train shape, about 0.04 ms); with G = 1 the
//     dK/dV pass writes bf16 directly;
//   * hd 256 is not covered: a warp's dK and dV accumulators alone would
//     take 256 registers a thread; it keeps ref.attention_bwd, as f32 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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
constexpr float LN2 = 0.6931471805599453f;

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
                 float* __restrict__ lse, int S, int Tk, int H, int K, float scale, int causal,
                 int q_off) {
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
    l = fmaxf(l, 1e-30f);
    inv[r] = 1.f / l;
    // under a gradient: the row's log-sum-exp of the scaled scores, natural log
    const int row = row0 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && row < S)
      lse[static_cast<size_t>(blockIdx.x) * S + row] = (m[r] + log2f(l)) * LN2;
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int K, int is_bf16, int causal, int q_off,
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
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, Tk, H, K,
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

// ---------------------------------------------------------------------------
// bf16 backward: tensor cores (see the backward's note at the top)
// ---------------------------------------------------------------------------
constexpr int BWD_THREADS = 128;   // 4 warps of 16 rows (query rows or keys)
constexpr int BWD_TILE = 64;       // query rows and keys per tile

// Whether a warp holds its A fragments of the tile it owns (q and dO in the
// dQ kernel, k and v in the dK/dV kernel) in registers for the whole loop;
// at hd 128 the dK and dV accumulators take 128 registers a thread, and the
// fragments are read from shared memory at each k-step instead.
template <int HD>
__host__ __device__ constexpr bool bwd_frags_in_registers() {
  return HD <= 64;
}

// six bf16 tiles of BWD_TILE rows (the owned pair and a two-stage ring of
// the streamed pair) and two stages of 64 log-sum-exps and 64 deltas
template <int HD>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 6 * BWD_TILE * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16)) +
         4 * BWD_TILE * static_cast<int>(sizeof(float));
}

// The A fragment (16 x 16) of rows [0, 16) and columns [c0, c0 + 16) of a
// row-major shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int c0,
                                       int lane) {
  mma::ldmatrix_x4(a, tile + (lane & 15) * LD + c0 + (lane >> 4) * 8);
}

// c[n] += a * B for the NT n-tiles of 8, where B[k][n] = tile[n][c0 + k]
// (the tile's rows are B's columns: x . rows).
template <int LD, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int c0, int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t r[4];
    mma::ldmatrix_x4(r, tile + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                            ((lane >> 3) & 1) * 8);
    mma::mma_bf16(c[2 * np], a, r[0], r[1]);
    mma::mma_bf16(c[2 * np + 1], a, r[2], r[3]);
  }
}

// acc[n] += x * tile over the tile's 64 rows, x (16 x 64) held as f32
// accumulator fragments and rounded to bf16 as A fragments (the layout of
// an m16n8 result is that of an m16k16 operand, two n-tiles a k-step).
template <int LD, int NTD>
__device__ __forceinline__ void mma_acc_by_tile(float (&acc)[NTD][4],
                                                const float (&x)[BWD_TILE / 8][4],
                                                const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
    const uint32_t a[4] = {mma::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           mma::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           mma::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           mma::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NTD / 2; ++dp) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dp * 16 + (lane >> 4) * 8);
      mma::mma_bf16(acc[2 * dp], a, r[0], r[1]);
      mma::mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
    }
  }
}

// Copy rows [r0, r0 + BWD_TILE) of a (rows, stride) bf16 array into a shared
// tile, rows at or past `rows` zero-filled.
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int rows, int tid) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  for (int i = tid; i < BWD_TILE * CPR; i += BWD_THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = r0 + r < rows;
    mma::cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * stride + c : src, ok);
  }
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 a = mma::unpack_bf16(xs[j]);
    const float2 b = mma::unpack_bf16(ys[j]);
    d += a.x * b.x + a.y * b.y;
  }
  return d;
}

// dQ, and the row statistics the dK/dV kernel reads: one CTA per (b * h,
// 64-row q tile), heaviest first, each warp owning 16 query rows; it loops
// over the key tiles its rows see. stats: (2, B * H, S_pad) f32, the rows'
// log-sum-exps in base 2 (+inf past S, so P = 0 there) and their deltas.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
k1_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                 __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int S, int Tk,
                 int H, int K, int S_pad, float scale, int causal, int q_off) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  constexpr int NTK = BWD_TILE / 8;   // key n-tiles of S and dP
  constexpr int NTD = HD / 8;         // head-dim n-tiles of dQ
  constexpr bool FREG = bwd_frags_in_registers<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BWD_TILE x LD
  __nv_bfloat16* sG = sQ + BWD_TILE * LD;                            // dO, BWD_TILE x LD
  __nv_bfloat16* sK = sG + BWD_TILE * LD;                            // 2 stages
  __nv_bfloat16* sV = sK + 2 * BWD_TILE * LD;                        // 2 stages
  float* sStat = reinterpret_cast<float*>(sV + 2 * BWD_TILE * LD);  // lse2[64], delta[64]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BWD_TILE;   // heaviest tile first
  const int row0 = q0 + warp * 16;
  const int grow0 = q_off + row0;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const size_t q_base = (static_cast<size_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Tk * K + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Tk * K + kvh) * HD;

  copy_tile<HD>(sQ, q + q_base, q_stride, q0, S, tid);
  copy_tile<HD>(sG, dout + q_base, q_stride, q0, S, tid);
  const int kv_end = causal ? min(Tk, q_off + q0 + BWD_TILE) : Tk;
  const int n_tiles = (kv_end + BWD_TILE - 1) / BWD_TILE;
  copy_tile<HD>(sK, kb, kv_stride, 0, Tk, tid);
  copy_tile<HD>(sV, vb, kv_stride, 0, Tk, tid);
  mma::cp_async_commit();

  // delta = rowsum(dO * O) and the base-2 log-sum-exp of this warp's rows,
  // while the copies fly; each row's HD / 8 chunks lie in adjacent lanes
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int row = row0 + r;
    float d = 0.f;
    if (row < S)
      d = dot8(*reinterpret_cast<const uint4*>(o + q_base + row * q_stride + c),
               *reinterpret_cast<const uint4*>(dout + q_base + row * q_stride + c));
#pragma unroll
    for (int off = CPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (i % CPR == 0) {
      const float l2 = row < S ? lse[static_cast<size_t>(bh) * S + row] * LOG2E : INFINITY;
      sStat[warp * 16 + r] = l2;
      sStat[BWD_TILE + warp * 16 + r] = d;
      const size_t at = static_cast<size_t>(bh) * S_pad + row;
      stats[at] = l2;
      stats[static_cast<size_t>(gridDim.x) * S_pad + at] = d;
    }
  }
  __syncwarp();
  const float lse2[2] = {sStat[warp * 16 + g], sStat[warp * 16 + g + 8]};
  const float delta[2] = {sStat[BWD_TILE + warp * 16 + g], sStat[BWD_TILE + warp * 16 + g + 8]};

  uint32_t qf[FREG ? HD / 16 : 1][4];
  uint32_t gf[FREG ? HD / 16 : 1][4];
  float acc[NTD][4];
#pragma unroll
  for (int d = 0; d < NTD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* wq = sQ + warp * 16 * LD;
  const __nv_bfloat16* wg = sG + warp * 16 * LD;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BWD_TILE;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      copy_tile<HD>(sK + st * BWD_TILE * LD, kb, kv_stride, k0 + BWD_TILE, Tk, tid);
      copy_tile<HD>(sV + st * BWD_TILE * LD, vb, kv_stride, k0 + BWD_TILE, Tk, tid);
      mma::cp_async_commit();
    }
    if constexpr (FREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          load_a<LD>(qf[kk], wq, kk * 16, lane);
          load_a<LD>(gf[kk], wg, kk * 16, lane);
        }
      }
    }
    if (causal && k0 > grow0 + 15) continue;   // warp-uniform: all its rows precede the tile
    const __nv_bfloat16* tk = sK + (it & 1) * BWD_TILE * LD;
    const __nv_bfloat16* tv = sV + (it & 1) * BWD_TILE * LD;

    // S = Q K^T, dP = dO V^T
    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ga[4];
      if constexpr (FREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) { a[j] = qf[kk][j]; ga[j] = gf[kk][j]; }
      } else {
        load_a<LD>(a, wq, kk * 16, lane);
        load_a<LD>(ga, wg, kk * 16, lane);
      }
      mma_rows<LD, NTK>(s, a, tk, kk * 16, lane);
      mma_rows<LD, NTK>(dp, ga, tv, kk * 16, lane);
    }

    // P = 2^(S scale log2 e - lse2), 0 where masked; dS = P (dP - delta)
    const bool masked = (k0 + BWD_TILE > Tk) || (causal && k0 + BWD_TILE - 1 > grow0);
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(s[n][e] * scale2 - lse2[e >> 1]);
        if (masked) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = grow0 + g + (e >> 1) * 8;
          if (key >= Tk || (causal && key > row)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - delta[e >> 1]);
      }
    }
    // dQ += dS K
    mma_acc_by_tile<LD, NTD>(acc, s, tk, lane);
  }

  // dq = scale * acc, through this warp's rows of sQ (no other warp reads them)
  __nv_bfloat16* so = sQ + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < NTD; ++d) {
    *reinterpret_cast<uint32_t*>(so + g * LD + d * 8 + 2 * t4) =
        mma::pack_bf16(acc[d][0] * scale, acc[d][1] * scale);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + d * 8 + 2 * t4) =
        mma::pack_bf16(acc[d][2] * scale, acc[d][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dq + q_base + (row0 + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(so + r * LD + c);
  }
}

// dK and dV of one query head: one CTA per (b * h, 64-key tile), the
// heaviest (first) key tiles first, each warp owning 16 keys; it loops over
// the q tiles that see its keys (under the causal mask from the diagonal
// on), computing the transposed scores so that P^T and dS^T are A
// fragments in registers. With one query head per KV head (dk_part null)
// it writes dk, dv in bf16; else f32 partials (B, Tk, H, hd) that
// k1_bwd_gsum_kernel sums over each KV head's group.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
k1_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float* __restrict__ dk_part,
                   float* __restrict__ dv_part, int S, int Tk, int H, int K, int S_pad,
                   float scale, int causal, int q_off) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;
  constexpr int NTQ = BWD_TILE / 8;   // query n-tiles of S^T and dP^T
  constexpr int NTD = HD / 8;         // head-dim n-tiles of dK and dV
  constexpr bool FREG = bwd_frags_in_registers<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BWD_TILE x LD
  __nv_bfloat16* sV = sK + BWD_TILE * LD;                            // BWD_TILE x LD
  __nv_bfloat16* sQ = sV + BWD_TILE * LD;                            // 2 stages
  __nv_bfloat16* sG = sQ + 2 * BWD_TILE * LD;                        // dO, 2 stages
  float* sStat = reinterpret_cast<float*>(sG + 2 * BWD_TILE * LD);  // 2 x (lse2, delta)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / K);
  const int k0 = blockIdx.y * BWD_TILE;
  const int kw = k0 + warp * 16;   // this warp's first key
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* gb = dout + (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * Tk * K + kvh) * HD;
  const float* lse2b = stats + static_cast<size_t>(bh) * S_pad;
  const float* deltab = lse2b + static_cast<size_t>(gridDim.x) * S_pad;

  copy_tile<HD>(sK, k + kv_base, kv_stride, k0, Tk, tid);
  copy_tile<HD>(sV, v + kv_base, kv_stride, k0, Tk, tid);
  auto load_q = [&](int stage, int qs) {
    copy_tile<HD>(sQ + stage * BWD_TILE * LD, qb, q_stride, qs, S, tid);
    copy_tile<HD>(sG + stage * BWD_TILE * LD, gb, q_stride, qs, S, tid);
    if (tid < 2 * BWD_TILE / 4) {   // 64 lse2 then 64 deltas, 16 bytes a thread
      const int c = (tid % (BWD_TILE / 4)) * 4;
      const float* src = (tid < BWD_TILE / 4 ? lse2b : deltab) + qs + c;
      mma::cp_async16(sStat + stage * 2 * BWD_TILE + (tid / (BWD_TILE / 4)) * BWD_TILE + c,
                      src, true);
    }
  };
  // the first q row that sees key k0 (every row past the end: none)
  const int q_begin = causal ? max(0, k0 - q_off) / BWD_TILE * BWD_TILE : 0;
  const int n_tiles = q_begin < S ? (S - q_begin + BWD_TILE - 1) / BWD_TILE : 0;
  if (n_tiles > 0) load_q(0, q_begin);
  mma::cp_async_commit();

  uint32_t kf[FREG ? HD / 16 : 1][4];
  uint32_t vf[FREG ? HD / 16 : 1][4];
  float dka[NTD][4], dva[NTD][4];
#pragma unroll
  for (int d = 0; d < NTD; ++d)
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = dva[d][0] = dva[d][1] = dva[d][2] =
        dva[d][3] = 0.f;
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* wk = sK + warp * 16 * LD;
  const __nv_bfloat16* wv = sV + warp * 16 * LD;
  const bool live = kw < Tk;

  for (int it = 0; it < n_tiles; ++it) {
    const int qs = q_begin + it * BWD_TILE;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_q((it + 1) & 1, qs + BWD_TILE);
      mma::cp_async_commit();
    }
    if constexpr (FREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          load_a<LD>(kf[kk], wk, kk * 16, lane);
          load_a<LD>(vf[kk], wv, kk * 16, lane);
        }
      }
    }
    // warp-uniform: no key of the warp lies before T and on or below a row of the tile
    if (!live || (causal && kw > q_off + qs + BWD_TILE - 1)) continue;
    const __nv_bfloat16* tq = sQ + (it & 1) * BWD_TILE * LD;
    const __nv_bfloat16* tg = sG + (it & 1) * BWD_TILE * LD;
    const float* tl = sStat + (it & 1) * 2 * BWD_TILE;
    const float* td = tl + BWD_TILE;

    // S^T = K Q^T
    float s[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (FREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = kf[kk][j];
      } else {
        load_a<LD>(a, wk, kk * 16, lane);
      }
      mma_rows<LD, NTQ>(s, a, tq, kk * 16, lane);
    }
    // P^T = 2^(S^T scale log2 e - lse2 of each query column), 0 where masked
    const bool masked = (kw + 16 > Tk) || (causal && kw + 15 > q_off + qs);
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(tl + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(s[n][e] * scale2 - ((e & 1) ? l2.y : l2.x));
        if (masked) {
          const int key = kw + g + (e >> 1) * 8;
          const int row = q_off + qs + n * 8 + 2 * t4 + (e & 1);
          if (key >= Tk || (causal && key > row)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // dV += P^T dO
    mma_acc_by_tile<LD, NTD>(dva, s, tg, lane);
    // dP^T = V dO^T
    float dpt[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (FREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = vf[kk][j];
      } else {
        load_a<LD>(a, wv, kk * 16, lane);
      }
      mma_rows<LD, NTQ>(dpt, a, tg, kk * 16, lane);
    }
    // dS^T = P^T (dP^T - delta of each query column)
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(td + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dpt[n][e] - ((e & 1) ? d2.y : d2.x);
    }
    // dK += dS^T Q
    mma_acc_by_tile<LD, NTD>(dka, s, tq, lane);
  }
  mma::cp_async_wait<0>();   // with no q tile to walk, the K/V copy may still fly
  __syncthreads();
  if (!live) return;

  if (dk_part == nullptr) {
    // bf16, through this warp's rows of sK / sV (no other warp reads them)
    __nv_bfloat16* ok_ = sK + warp * 16 * LD;
    __nv_bfloat16* ov_ = sV + warp * 16 * LD;
#pragma unroll
    for (int d = 0; d < NTD; ++d) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = (g + 8 * half) * LD + d * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(ok_ + at) =
            mma::pack_bf16(dka[d][2 * half] * scale, dka[d][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(ov_ + at) =
            mma::pack_bf16(dva[d][2 * half], dva[d][2 * half + 1]);
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR;
      const int c = (i % CPR) * 8;
      if (kw + r < Tk) {
        const size_t at = kv_base + (kw + r) * kv_stride + c;
        *reinterpret_cast<uint4*>(dk + at) = *reinterpret_cast<const uint4*>(ok_ + r * LD + c);
        *reinterpret_cast<uint4*>(dv + at) = *reinterpret_cast<const uint4*>(ov_ + r * LD + c);
      }
    }
  } else {
    // f32 partials of query head h
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw + g + 8 * half;
      if (key >= Tk) continue;
      const size_t row = ((static_cast<size_t>(b) * Tk + key) * H + h) * HD;
#pragma unroll
      for (int d = 0; d < NTD; ++d) {
        *reinterpret_cast<float2*>(dk_part + row + d * 8 + 2 * t4) =
            make_float2(dka[d][2 * half] * scale, dka[d][2 * half + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + row + d * 8 + 2 * t4) =
            make_float2(dva[d][2 * half], dva[d][2 * half + 1]);
      }
    }
  }
}

// dk, dv (B, Tk, K, hd) bf16 = the sums, in head order, of the G query
// heads' f32 partials (B, Tk, K * G, hd); blockIdx.y picks dk or dv.
__global__ void k1_bwd_gsum_kernel(const float* __restrict__ dk_part,
                                   const float* __restrict__ dv_part,
                                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                   size_t n4, int G, int hd4) {
  const float4* src = reinterpret_cast<const float4*>(blockIdx.y ? dv_part : dk_part);
  __nv_bfloat16* dst = blockIdx.y ? dv : dk;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / hd4;   // (b * Tk + t) * K + kv head
    const int d4 = static_cast<int>(i % hd4);
    const float4* p = src + row * G * hd4 + d4;
    float4 acc = p[0];
    for (int j = 1; j < G; ++j) {
      const float4 x = p[static_cast<size_t>(j) * hd4];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    *reinterpret_cast<uint2*>(dst + i * 4) =
        make_uint2(mma::pack_bf16(acc.x, acc.y), mma::pack_bf16(acc.z, acc.w));
  }
}

// the row count of the backward's statistics: S rounded up to a whole tile
int bwd_stats_rows(int S) { return (S + BWD_TILE - 1) / BWD_TILE * BWD_TILE; }

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* stats, float* dk_part, float* dv_part, int B, int S, int Tk,
                       int H, int K, int causal, int q_off, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  constexpr int smem = bwd_smem_bytes<HD>();
  static std::atomic<unsigned long long> dq_configured{0}, dkdv_configured{0};
  cudaError_t err = mma::set_smem_once(k1_bwd_dq_kernel<HD>, smem, dq_configured);
  if (err == cudaSuccess)
    err = mma::set_smem_once(k1_bwd_dkdv_kernel<HD>, smem, dkdv_configured);
  if (err != cudaSuccess) return err;
  const int S_pad = bwd_stats_rows(S);
  k1_bwd_dq_kernel<HD><<<dim3(B * H, S_pad / BWD_TILE), BWD_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, static_cast<bf*>(dq),
      stats, S, Tk, H, K, S_pad, scale, causal, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_bwd_dkdv_kernel<HD><<<dim3(B * H, (Tk + BWD_TILE - 1) / BWD_TILE), BWD_THREADS, smem,
                           stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), stats, static_cast<bf*>(dk), static_cast<bf*>(dv),
      dk_part, dv_part, S, Tk, H, K, S_pad, scale, causal, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == K) return err;
  const size_t n4 = static_cast<size_t>(B) * Tk * K * HD / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 132 * 16));
  k1_bwd_gsum_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(
      dk_part, dv_part, static_cast<bf*>(dk), static_cast<bf*>(dv), n4, H / K, HD / 4);
  return cudaGetLastError();
}

}  // namespace

// q, o: contiguous (B, S, H, hd); k, v: contiguous (B, Tk, K, hd) with
// H % K == 0; all 16-byte aligned device arrays, all float32 (is_bf16 = 0)
// or all bfloat16 (is_bf16 = 1); hd in {32, 64, 128, 256}; q_off >= 0 the
// global row of q's first row in the causal mask; lse null, or (bf16
// only) a contiguous (B, H, S) float32 array that takes each row's
// log-sum-exp of the scaled scores. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int k1_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int Tk, int H, int K, int hd,
                                      int is_bf16, int causal, int q_off, void* lse,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || K <= 0 || H % K != 0 || q_off < 0 ||
      (lse != nullptr && !is_bf16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, l, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 64: return launch<64>(q, k, v, o, l, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 128: return launch<128>(q, k, v, o, l, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    case 256: return launch<256>(q, k, v, o, l, B, S, Tk, H, K, is_bf16, causal, q_off, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 backward of the forward above: q, o, dout, dq (B, S, H, hd);
// k, v, dk, dv (B, Tk, K, hd); lse (B, H, S) f32 from the forward; all
// contiguous, 16-byte aligned, hd in {32, 64, 128}. Scratch the caller
// allocates: stats (2, B * H, k1_bwd_stats_rows(S)) f32 and, when H > K, dk_part and dv_part (B, Tk, H, hd) f32 (null when
// H == K). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int k1_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv, void* stats,
                                      void* dk_part, void* dv_part, int B, int S, int Tk,
                                      int H, int K, int hd, int causal, int q_off,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0 || K <= 0 || H % K != 0 || q_off < 0 ||
      ((dk_part == nullptr || dv_part == nullptr) != (H == K)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sts = static_cast<float*>(stats);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  const int off = causal ? q_off : 0;
  switch (hd) {
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, l, dq, dk, dv, sts, pk, pv, B, S, Tk, H, K,
                            causal, off, st);
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, l, dq, dk, dv, sts, pk, pv, B, S, Tk, H, K,
                            causal, off, st);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, l, dq, dk, dv, sts, pk, pv, B, S, Tk, H, K,
                             causal, off, st);
    default: return cudaErrorInvalidValue;
  }
}

// The row count of k1_flash_attention_bwd's stats scratch for S queries.
extern "C" int k1_bwd_stats_rows(int S) { return bwd_stats_rows(S); }

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
