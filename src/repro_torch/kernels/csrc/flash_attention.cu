// K1: flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention() there). Same function: full-H attention
// q, k, v (B, S|T, H, hd) -> o (B, S, H, hd), inputs cast to f32, scale
// 1/sqrt(hd), causal mask -1e30 (query i sees keys j <= i), online softmax
// with f32 running m / l / acc, l clamped to >= 1e-30, output rounded to
// the input dtype. Beyond the Pallas kernel's domain, any S and T work:
// the ragged edge is masked here instead of asserting block divisibility.
//
// Design (simple and right first):
//   * one CTA per (b*h, 64-row q tile); the TPU's sequential kv grid axis
//     becomes a loop over kv tiles inside the CTA;
//   * each query row is owned by HD/32 adjacent threads, each holding 32
//     of its q and acc values in registers (f32); a score is a partial dot
//     product per thread summed with warp shuffles;
//   * K and V tiles (4096 f32 each, 32 KB together) are staged in shared
//     memory, converted to f32 once per tile; a thread's float4 columns
//     interleave with its row-mates' so a warp's reads are broadcasts
//     without bank conflicts;
//   * the online softmax advances 16 keys at a time (one rescale of acc
//     per 16 keys);
//   * causal early exit: a CTA stops at the last kv position its rows can
//     see (replaces pl.when(live)), and q tiles are scheduled heaviest
//     first.
//
// Bound at the serving shape of qwen2-0.5b (B=8, S=T=512, H=14, hd=64,
// bf16, causal): 4*B*H*hd*S(S+1)/2 = 3.77 GFLOP, 3.8 us at the bf16 tensor
// rate of 989 TFLOP/s; q, k, v and o are 4 * 7.34 MB = 29.4 MB, because the
// full-H k and v are materialised by repeat_kv, 8.8 us at 3.35 TB/s. So it
// is memory-bound at about 9 us per launch. This kernel does its products
// as scalar f32 FMAs (no tensor cores), whose peak of 67 TFLOP/s puts its
// own floor near 56 us; wgmma, TMA and warp specialisation are later work.
// The obvious later gain on bytes: read the K-head k/v directly
// (GQA-folded) instead of the repeated full-H copies, which cuts the
// k and v traffic by the group size (7 for qwen2-0.5b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;             // query rows per CTA
constexpr int KC = 16;             // keys per online-softmax step
constexpr int TILE_FLOATS = 4096;  // f32 values per staged K (and V) tile
constexpr float NEG_INF = -1e30f;  // the reference's mask value

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

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * (HD / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int Tk, int H, float scale, int causal) {
  constexpr int TPR = HD / 32;   // threads per query row
  constexpr int NT = BQ * TPR;   // threads per CTA
  constexpr int C4 = HD / 4;     // float4 columns per row
  constexpr int NC = C4 / TPR;   // float4 columns per thread (8)
  constexpr int BK = TILE_FLOATS / HD;  // kv rows per staged tile

  __shared__ float4 ks[TILE_FLOATS / 4];
  __shared__ float4 vs[TILE_FLOATS / 4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;    // this thread owns columns c * TPR + part
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int qi = q0 + row;
  const size_t row_stride = static_cast<size_t>(H) * HD;
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Tk * H + h) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Tk * H + h) * HD;

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

  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK * C4; i += NT) {
      const int t = k0 + i / C4;
      const int col = (i % C4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (t < Tk) {
        kk = load4(kb + t * row_stride + col);
        vv = load4(vb + t * row_stride + col);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    const int tile_end = min(BK, kv_end - k0);
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
        else if (causal && t > qi) x = NEG_INF;     // the reference's mask
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
    T* ob = o + (static_cast<size_t>(b) * S * H + h) * HD + qi * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store4(ob + (c * TPR + part) * 4,
             make_float4(acc[c].x / lc, acc[c].y / lc, acc[c].z / lc, acc[c].w / lc));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int causal, cudaStream_t stream) {
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  const dim3 block(BQ * (HD / 32));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_fwd_kernel<T, HD><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Tk, int H, int hd, int causal,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (B, S|Tk, H, hd) device arrays, 16-byte aligned,
// all float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1); hd in {32, 64,
// 128}. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int k1_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Tk, int H, int hd, int is_bf16,
                                      int causal, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || H <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, hd, causal, st)
                 : dispatch_hd<float>(q, k, v, o, B, S, Tk, H, hd, causal, st);
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
