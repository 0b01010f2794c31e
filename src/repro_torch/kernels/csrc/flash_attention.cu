// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/flash_attention.py: _flash_fwd / _fwd_kernel (lines
// 42-203). For q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] it computes
//   out[b, i, h] = sum_j softmax_j(scale q_i . k_j) v_j
// over the keys j that the masks keep: j < Skv, j <= q_offset + i when
// causal, j > q_offset + i - window when a window is set; query head h reads
// KV head h / (Hq / Hkv) (GQA). It also writes lse[b, h, i], the log-sum-exp
// of the kept scaled scores, +inf on a row that keeps no key (whose out is
// 0), as the TPU kernel emits it for its backward. Inputs are float32 or
// bf16; every sum runs in float32 and out is written in the input's type.
//
// What bounds it on this card. At the serving path's shapes (B 8, S 2,048,
// 25 query and 5 KV heads, D 64) the work is 4 B Hq D (S^2 / 2) = 1.1e11
// operations against 2 x 42 MB of q/k/v/out: operations, ~0.11 ms at the
// bf16 tensor-core peak.
//
// What the design does about it. This first kernel is the simple one: no
// tensor cores (wgmma or mma.sync come in a later change), float32 fused
// multiply-adds on the CUDA cores, so it runs near the 67 TFLOP/s fp32 rate
// at best. A block owns 64 query rows of one (batch, head), one thread per
// row; the row's scaled query and its float32 accumulator sit in registers.
// The block walks the key tiles of 32 that the causal and window band can
// reach (tiles wholly outside it contribute p = 0 and are skipped, which is
// exact and cuts a sliding-window layer's work by about a quarter at S =
// 2,048), staging each tile's keys and values in shared memory as float32,
// where every thread reads them as broadcasts. Per tile each row updates the
// online softmax (running max m, normaliser l, accumulator), with the
// reference's rules: masked scores are -1e30, p is zeroed while the row's
// max is still -1e30, out = acc / l where l > 0 else 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // query rows per block, one thread each
constexpr int kTile = 32;  // keys per staged tile
constexpr int kMaxD = 64;  // head dims up to 64, padded to 64

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashArgs {
  const void* q;  // [B, Sq, Hq, D]
  const void* k;  // [B, Skv, Hkv, D]
  const void* v;  // [B, Skv, Hkv, D]
  void* out;      // [B, Sq, Hq, D]
  float* lse;     // [B, Hq, Sq]
  int sq, skv, hq, hkv, d;
  int causal, window, q_offset;  // window < 0: no window
  float scale;
};

// DP: the head dim's register width (zeros past d); one width, 64, is
// built: every config the port serves has head_dim 64, and each width is
// a large unrolled body that adds its share to the build time.
template <typename T, int DP>
__global__ void __launch_bounds__(kRows) flash_fwd_kernel(FlashArgs a) {
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int row = tile * kRows + threadIdx.x;
  const bool live = row < a.sq;
  const int qpos = row + a.q_offset;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  float qr[DP], acc[DP];
  const size_t qoff = (((size_t)b * a.sq + row) * a.hq + h) * a.d;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (live && d < a.d) ? __fmul_rn(to_f32(q[qoff + d]), a.scale) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  // the key range any row of this tile can keep
  const int pos_lo = tile * kRows + a.q_offset;
  const int pos_hi = min(tile * kRows + kRows, a.sq) - 1 + a.q_offset;
  const int k_lo = a.window >= 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.skv, pos_hi + 1) : a.skv;

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTile * DP; i += kRows) {
      const int j = i / DP, d = i % DP, kp = k0 + j;
      const bool ok = kp < a.skv && d < a.d;
      const size_t off = (((size_t)b * a.skv + kp) * a.hkv + hk) * a.d + d;
      ks[j][d] = ok ? to_f32(k[off]) : 0.0f;
      vs[j][d] = ok ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[j] = 0.0f;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = __fmaf_rn(qr[d], kk.x, s[j]);
        s[j] = __fmaf_rn(qr[d + 1], kk.y, s[j]);
        s[j] = __fmaf_rn(qr[d + 2], kk.z, s[j]);
        s[j] = __fmaf_rn(qr[d + 3], kk.w, s[j]);
      }
    }
    float mcur = kNeg;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int kp = k0 + j;
      const bool keep = kp < a.skv && (!a.causal || kp <= qpos) &&
                        (a.window < 0 || kp > qpos - a.window);
      s[j] = keep ? s[j] : kNeg;
      mcur = fmaxf(mcur, s[j]);
    }
    const float mnew = fmaxf(m, mcur);
    const float alpha = expf(m - mnew);
    const bool alive = mnew > 0.5f * kNeg;
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = alive ? expf(s[j] - mnew) : 0.0f;
      psum = __fadd_rn(psum, s[j]);
    }
    l = __fmaf_rn(l, alpha, psum);
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] = __fmul_rn(acc[d], alpha);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = __fmaf_rn(s[j], vv.x, acc[d]);
        acc[d + 1] = __fmaf_rn(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = __fmaf_rn(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = __fmaf_rn(s[j], vv.w, acc[d + 3]);
      }
    }
    m = mnew;
  }

  if (!live) return;
  T* out = static_cast<T*>(a.out);
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    if (d < a.d) out[qoff + d] = from_f32<T>(l > 0.0f ? __fdiv_rn(acc[d], lc) : 0.0f);
  }
  a.lse[((size_t)b * a.hq + h) * a.sq + row] =
      l > 0.0f ? m + logf(fmaxf(l, 1e-30f)) : INFINITY;
}

template <typename T, int DP>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.sq + kRows - 1) / kRows, a.hq, batch);
  flash_fwd_kernel<T, DP><<<grid, kRows, 0, stream>>>(a);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// Largest head dim the kernel takes.
int flash_attention_limits(int* max_d) {
  *max_d = kMaxD;
  return 0;
}

// dtype: 0 float32, 1 bfloat16. window < 0: none. Returns a cudaError_t.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               float* lse, int batch, int sq, int skv, int hq, int hkv,
                               int d, int causal, int window, int q_offset, float scale,
                               int dtype, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv != 0 || d < 1 || d > kMaxD ||
      (dtype != 0 && dtype != 1) || batch > 65535 || hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  FlashArgs a{q, k, v, out, lse, sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float, kMaxD>(a, batch, s) : launch<__nv_bfloat16, kMaxD>(a, batch, s);
}

}  // extern "C"
