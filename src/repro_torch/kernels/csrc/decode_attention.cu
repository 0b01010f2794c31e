// Decode attention (one new query token per sequence over its KV cache), for
// Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/decode_attention.py: decode_attention_pallas /
// _decode_kernel (lines 42-151). For q [B, Hq, D] and a cache k, v
// [B, S, Hkv, D] it computes
//   out[b, h] = sum_{p < lengths[b]} softmax_p(scale q_h . k_p) v_p
// with query head h reading KV head h / G, G = Hq / Hkv (GQA); a sequence
// with no valid position gets 0. Inputs are float32 or bf16; every sum runs
// in float32 and out is written in the input's type.
//
// What bounds it on this card. Decoding reads the whole valid cache once
// per step for a handful of operations per byte: bytes. At the serving
// path's shapes (B 8, a 2,112-slot global cache, 5 KV heads of 64) that is
// 21.6 MB, 6.5 us at 3.35 TB/s.
//
// What the design does about it. As on the TPU, all G query heads of a KV
// group are served by one block, so each cache row is read from device
// memory once for the whole group. A block owns one (batch, KV head); its
// 16 warps stride over the valid positions, 4 at a time, and a warp reads
// a key or value row with its 32 lanes side by side (coalesced). Each warp
// keeps an online softmax (max, normaliser, accumulator) per query head over
// its own positions, in registers; at the end the warps' states are merged
// in shared memory (rescaled to the common max) and divided out. Positions
// at or past lengths[b] are not read at all, which is exact: they contribute
// p = 0. One block per (batch, KV head) is 40 blocks at B = 8, a third of
// the 132 SMs; splitting the positions over more blocks (split-S, with a
// second pass to merge) is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 16;
constexpr int kUnroll = 4;  // positions per warp per step
constexpr int kMaxG = 8;    // query heads per KV head
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct DecodeArgs {
  const void* q;        // [B, Hq, D]
  const void* k;        // [B, S, Hkv, D]
  const void* v;        // [B, S, Hkv, D]
  const int* lengths;   // [B]
  void* out;            // [B, Hq, D]
  int s, hq, hkv, d;
  float scale;
};

// PL: elements of a row per lane (lane + 32 i for i < PL), PL * 32 >= D.
template <typename T, int PL>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(DecodeArgs a) {
  // the warps' softmax states: m and l [kWarps][G], acc [kWarps][G][D]
  extern __shared__ float smem[];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = a.hq / a.hkv;
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  float qv[kMaxG][PL], m[kMaxG], l[kMaxG], acc[kMaxG][PL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int d = lane + 32 * i;
      qv[g][i] = (g < G && d < a.d)
                     ? __fmul_rn(to_f32(q[((size_t)b * a.hq + hk * G + g) * a.d + d]), a.scale)
                     : 0.0f;
      acc[g][i] = 0.0f;
    }
  }

  const int len = min(a.lengths[b], a.s);
  for (int p0 = warp * kUnroll; p0 < len; p0 += kWarps * kUnroll) {
    float kr[kUnroll][PL], vr[kUnroll][PL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u;
      const size_t base = (((size_t)b * a.s + p) * a.hkv + hk) * a.d;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int d = lane + 32 * i;
        const bool ok = p < len && d < a.d;
        kr[u][i] = ok ? to_f32(k[base + d]) : 0.0f;
        vr[u][i] = ok ? to_f32(v[base + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mnew = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < PL; ++i) part = __fmaf_rn(qv[g][i], kr[u][i], part);
        s[u] = p0 + u < len ? warp_sum(part) : kNeg;
        mnew = fmaxf(mnew, s[u]);
      }
      // every step holds at least one valid position, so mnew is a score
      const float alpha = expf(m[g] - mnew);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = expf(s[u] - mnew);
        psum = __fadd_rn(psum, s[u]);
      }
      l[g] = __fmaf_rn(l[g], alpha, psum);
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        float x = __fmul_rn(acc[g][i], alpha);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = __fmaf_rn(s[u], vr[u][i], x);
        acc[g][i] = x;
      }
      m[g] = mnew;
    }
  }

  // merge the warps' softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int d = lane + 32 * i;
      if (d < a.d) sm_acc[(warp * G + g) * a.d + d] = acc[g][i];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int o = threadIdx.x; o < G * a.d; o += kWarps * 32) {
    const int g = o / a.d, d = o % a.d;
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lt = 0.0f, at = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no position has l = 0 and acc = 0
      const float c = sm_l[w * G + g] > 0.0f ? expf(sm_m[w * G + g] - mx) : 0.0f;
      lt = __fmaf_rn(sm_l[w * G + g], c, lt);
      at = __fmaf_rn(sm_acc[(w * G + g) * a.d + d], c, at);
    }
    out[((size_t)b * a.hq + hk * G + g) * a.d + d] =
        from_f32<T>(lt > 0.0f ? __fdiv_rn(at, fmaxf(lt, 1e-30f)) : 0.0f);
  }
}

template <typename T, int PL>
int launch(const DecodeArgs& a, int batch, cudaStream_t stream) {
  const int G = a.hq / a.hkv;
  const size_t bytes = sizeof(float) * kWarps * G * (2 + (size_t)a.d);
  static size_t attr_bytes = 48 * 1024;
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  decode_kernel<T, PL><<<dim3(a.hkv, batch), kWarps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pl(const DecodeArgs& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 1>(a, batch, stream);
  if (a.d <= 64) return launch<T, 2>(a, batch, stream);
  return launch<T, 4>(a, batch, stream);
}

}  // namespace

extern "C" {

// Largest query heads per KV head and head dim the kernel takes.
int decode_attention_limits(int* max_group, int* max_d) {
  *max_group = kMaxG;
  *max_d = kMaxD;
  return 0;
}

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, int batch, int s, int hq, int hkv, int d, float scale,
                            int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kMaxG ||
      d < 1 || d > kMaxD || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeArgs a{q, k, v, lengths, out, s, hq, hkv, d, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch_pl<float>(a, batch, st) : launch_pl<__nv_bfloat16>(a, batch, st);
}

}  // extern "C"
