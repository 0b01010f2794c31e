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
// Every kernel here takes head dims up to 128 (the reference's Pallas
// kernels pad D to 128 lanes), each compiled at two widths: D <= 64 runs the
// width-64 instance, 64 < D <= 128 the width-128 one.
//
// What bounds it on this card. At the serving path's shapes (B 8, S 2,048,
// 25 query and 5 KV heads, D 64) the work is 4 B Hq D (S^2 / 2) = 1.1e11
// operations against 2 x 42 MB of q/k/v/out: operations, ~0.11 ms at the
// bf16 tensor-core peak; at qwen2-moe-a2.7b's (16 / 16 heads, D 128)
// 1.37e11, ~0.14 ms.
//
// Two kernels compute it. bf16 inputs, the serving and training paths',
// run flash_fwd_mma_kernel on the tensor cores (mma.sync, ldmatrix,
// cp.async; its note is further down, with the dk/dv kernel of the same
// design). float32 inputs run flash_fwd_kernel, described here: float32
// fused multiply-adds on the CUDA cores (TF32 stays off), so it runs near
// the 67 TFLOP/s fp32 rate at best. A block owns 64 query rows of one
// (batch, head), one thread per row at D <= 64 and two at D <= 128; the
// row's scaled query and its float32 accumulator sit in registers.
// The block walks the key tiles of 32 that the causal and window band can
// reach (tiles wholly outside it contribute p = 0 and are skipped, which is
// exact and cuts a sliding-window layer's work by about a quarter at S =
// 2,048), staging each tile's keys and values in shared memory as float32,
// where every thread reads them as broadcasts. Per tile each row updates the
// online softmax (running max m, normaliser l, accumulator), with the
// reference's rules: masked scores are -1e30, p is zeroed while the row's
// max is still -1e30, out = acc / l where l > 0 else 0.

// The backward (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) follows below,
// with its own note.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;      // query rows per block
constexpr int kTile = 32;      // keys per staged tile
constexpr int kNarrow = 64;    // the narrow instances' width (D <= 64)
constexpr int kMaxD = 128;     // the head dims every kernel takes (the wide instances' width)
constexpr unsigned kFull = 0xffffffffu;

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

// DP: the head dim's register width (zeros past d), 64 or 128. At 128 two
// neighbouring threads share a row (kP = 2), each holding 64 of its dims, the
// float4 chunks 2 c + part, so a thread keeps as many registers as at 64 (q
// and acc spill at 128 a thread) and the two threads of a row read
// neighbouring 16 B of a staged row; each score is finished by one shuffle,
// which leaves the same sum in both. At 64 (kP = 1) a thread owns its row.
template <int kP>
__device__ __forceinline__ int fwd_dim(int i, int part) {
  return 4 * ((i / 4) * kP + part) + (i % 4);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kRows * (DP / 64)) flash_fwd_kernel(FlashArgs a) {
  constexpr int kP = DP / 64;      // threads a row
  constexpr int kOwnF = DP / kP;   // dims a thread holds
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int part = threadIdx.x % kP;
  const int row = tile * kRows + threadIdx.x / kP;
  const bool live = row < a.sq;
  const int qpos = row + a.q_offset;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  float qr[kOwnF], acc[kOwnF];
  const size_t qoff = (((size_t)b * a.sq + row) * a.hq + h) * a.d;
#pragma unroll
  for (int i = 0; i < kOwnF; ++i) {
    const int d = fwd_dim<kP>(i, part);
    qr[i] = (live && d < a.d) ? __fmul_rn(to_f32(q[qoff + d]), a.scale) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  // the key range any row of this tile can keep
  const int pos_lo = tile * kRows + a.q_offset;
  const int pos_hi = min(tile * kRows + kRows, a.sq) - 1 + a.q_offset;
  const int k_lo = a.window >= 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.skv, pos_hi + 1) : a.skv;

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTile * DP; i += kRows * kP) {
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
    for (int c = 0; c < kOwnF; c += 4) {
      const int d = fwd_dim<kP>(c, part);
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = __fmaf_rn(qr[c], kk.x, s[j]);
        s[j] = __fmaf_rn(qr[c + 1], kk.y, s[j]);
        s[j] = __fmaf_rn(qr[c + 2], kk.z, s[j]);
        s[j] = __fmaf_rn(qr[c + 3], kk.w, s[j]);
      }
    }
    if constexpr (kP == 2) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = __fadd_rn(s[j], __shfl_xor_sync(kFull, s[j], 1));
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
    for (int i = 0; i < kOwnF; ++i) acc[i] = __fmul_rn(acc[i], alpha);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int c = 0; c < kOwnF; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][fwd_dim<kP>(c, part)]);
        acc[c] = __fmaf_rn(s[j], vv.x, acc[c]);
        acc[c + 1] = __fmaf_rn(s[j], vv.y, acc[c + 1]);
        acc[c + 2] = __fmaf_rn(s[j], vv.z, acc[c + 2]);
        acc[c + 3] = __fmaf_rn(s[j], vv.w, acc[c + 3]);
      }
    }
    m = mnew;
  }

  if (!live) return;
  T* out = static_cast<T*>(a.out);
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kOwnF; ++i) {
    const int d = fwd_dim<kP>(i, part);
    if (d < a.d) out[qoff + d] = from_f32<T>(l > 0.0f ? __fdiv_rn(acc[i], lc) : 0.0f);
  }
  if (part == 0) {
    a.lse[((size_t)b * a.hq + h) * a.sq + row] =
        l > 0.0f ? m + logf(fmaxf(l, 1e-30f)) : INFINITY;
  }
}

template <typename T, int DP>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.sq + kRows - 1) / kRows, a.hq, batch);
  flash_fwd_kernel<T, DP><<<grid, kRows * (DP / 64), 0, stream>>>(a);
  return (int)cudaGetLastError();
}


// ===========================================================================
// Backward.
//
// Replaces the reference package's Pallas TPU kernels
// src/repro/kernels/flash_attention.py: flash_attention_bwd_pallas (line 383)
// with its _bwd_dq_kernel (line 287) and _bwd_dkv_kernel (line 329). From the
// forward's out and lse and the output gradient dout it computes, over the
// pairs the masks keep,
//   delta_i = sum_d dout_i out_i,   p_ij = exp(scale q_i . k_j - lse_i),
//   ds_ij = p_ij (dout_i . v_j - delta_i),
//   dq_i = scale sum_j ds_ij k_j,   dk_j = scale sum_i ds_ij q_i,
//   dv_j = sum_i p_ij dout_i,
// where a KV head's dk and dv sum over the Hq / Hkv query heads that read it
// (GQA). A dead row (lse = +inf) has p = 0 and adds nothing. Inputs are
// float32 or bf16; every sum runs in float32 and the gradients are written
// once, in the input's type.
//
// What bounds it on this card. At the training path's shapes (TinyLlama:
// B 8, S 2,048, 32 query and 4 KV heads, D 64, causal) the two kernels do
// 7 products of 2 B Hq D (S^2 / 2) operations (s and dp in each kernel, then
// dq; dk and dv), 4.8e11 in all, against ~0.3 GB of inputs and outputs:
// operations, ~0.35 ms for the 5 products a fused backward needs at the bf16
// tensor-core peak.
//
// What the design does about it. These kernels are the simple kind,
// float32 fused multiply-adds on the CUDA cores, so the 67 TFLOP/s fp32
// rate is their ceiling. They run for float32 inputs; bf16 inputs run dq
// and dk/dv on the tensor cores (flash_bwd_dq_mma_kernel,
// flash_bwd_dkv_mma_kernel, below). A row carries three (dq) or four
// (dk/dv) head-dim vectors; one thread a row, as the forward has, would take
// ~200 registers for them alone and spill. So four neighbouring threads share
// a row, each holding a quarter of its dims (16 at width 64, 32 at width
// 128: dk/dv's four vectors are then 128 registers, under the 255 that 256
// threads a block allow), and the dot products s and dp are finished with
// two butterfly shuffles, which leave the same sum in all four lanes. A
// thread's dims are float4 chunks strided by four, so the four threads of a
// row read 64 consecutive bytes of a staged row from shared memory, free of
// bank conflicts. The staged tiles, [32 x width] float32, stay static (16
// KB each at width 128).
//
// - flash_bwd_dq_kernel: a block per (batch, query head, 64 query rows),
//   256 threads. Its prologue computes delta for its rows and writes it out
//   for the dk/dv kernel (the reference computes it with an einsum before
//   its kernels). It walks the key tiles of 32 that the causal and window
//   band reaches, skipping the rest as the forward does, stages each tile's
//   keys and values in shared memory as float32, recomputes p from lse and
//   accumulates dq in registers.
// - flash_bwd_dkv_kernel: a block per (batch, KV head, 64 keys), 256
//   threads. It walks the in-band query tiles of 32 rows of each of the
//   group's Hq / Hkv query heads, staging scaled q, dout, lse and delta, and
//   sums the whole group in registers, so dk and dv are written once, with
//   no float atomics: the result is the same from run to run. (The TPU
//   kernel writes per-query-head [B, Hq, Skv, D] and sums outside.)
// Blocks are ordered heaviest first under a causal mask (the last query
// tiles for dq, the first key tiles for dk/dv), so the short ones fill the
// tail of the grid.
// ===========================================================================
constexpr int kParts = 4;                      // threads sharing a row
constexpr int kBwdRows = 64;                   // dq: query rows a block
constexpr int kBwdKeys = 64;                   // dk/dv: keys a block
constexpr int kBwdTile = 32;                   // staged keys (dq) or query rows (dk/dv)

// dim of a thread's i-th owned value: chunk c = (i / 4) kParts + part
__device__ __forceinline__ int own_dim(int i, int part) {
  return 4 * ((i / 4) * kParts + part) + (i % 4);
}

// the sum over the row's kParts lanes; every lane gets the same value
__device__ __forceinline__ float row_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

struct BwdArgs {
  const void* q;     // [B, Sq, Hq, D]
  const void* k;     // [B, Skv, Hkv, D]
  const void* v;     // [B, Skv, Hkv, D]
  const void* out;   // [B, Sq, Hq, D] (dq kernel only)
  const void* dout;  // [B, Sq, Hq, D]
  const float* lse;  // [B, Hq, Sq]
  float* delta;      // [B, Hq, Sq]: written by the dq kernel, read by dk/dv
  void* dq;          // [B, Sq, Hq, D]
  void* dk;          // [B, Skv, Hkv, D]
  void* dv;          // [B, Skv, Hkv, D]
  int sq, skv, hq, hkv, d;
  int causal, window, q_offset;  // window < 0: no window
  float scale;
};

// staged rows [kBwdTile][DP] of a: the DP / kParts dims of this thread's
// part dotted with x, finished over the row's lanes
template <int DP>
__device__ __forceinline__ float staged_dot(const float (*rows)[DP], int j, int part,
                                            const float* x) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < DP / 4 / kParts; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(&rows[j][4 * (c * kParts + part)]);
    acc = __fmaf_rn(x[4 * c], y.x, acc);
    acc = __fmaf_rn(x[4 * c + 1], y.y, acc);
    acc = __fmaf_rn(x[4 * c + 2], y.z, acc);
    acc = __fmaf_rn(x[4 * c + 3], y.w, acc);
  }
  return row_sum(acc);
}

// acc += w * rows[j] over this thread's DP / kParts dims
template <int DP>
__device__ __forceinline__ void staged_axpy(const float (*rows)[DP], int j, int part,
                                            float w, float* acc) {
#pragma unroll
  for (int c = 0; c < DP / 4 / kParts; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(&rows[j][4 * (c * kParts + part)]);
    acc[4 * c] = __fmaf_rn(w, y.x, acc[4 * c]);
    acc[4 * c + 1] = __fmaf_rn(w, y.y, acc[4 * c + 1]);
    acc[4 * c + 2] = __fmaf_rn(w, y.z, acc[4 * c + 2]);
    acc[4 * c + 3] = __fmaf_rn(w, y.w, acc[4 * c + 3]);
  }
}

__device__ __forceinline__ bool keeps(const BwdArgs& a, int kp, int qpos) {
  return kp < a.skv && (!a.causal || kp <= qpos) && (a.window < 0 || kp > qpos - a.window);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdRows * kParts) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int kOwn = DP / kParts;  // dims a thread holds
  __shared__ __align__(16) float ks[kBwdTile][DP];
  __shared__ __align__(16) float vs[kBwdTile][DP];
  const int b = blockIdx.x / a.hq, h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int part = threadIdx.x % kParts;
  const int row = tile * kBwdRows + threadIdx.x / kParts;
  const bool live = row < a.sq;
  const int qpos = row + a.q_offset;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.out);
  const T* dout = static_cast<const T*>(a.dout);

  // the row's scaled query, output gradient and dq sum; delta in the prologue
  float qr[kOwn], dor[kOwn], acc[kOwn];
  const size_t qoff = (((size_t)b * a.sq + (live ? row : 0)) * a.hq + h) * a.d;
  float dsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int d = own_dim(i, part);
    const bool ok = live && d < a.d;
    qr[i] = ok ? __fmul_rn(to_f32(q[qoff + d]), a.scale) : 0.0f;
    dor[i] = ok ? to_f32(dout[qoff + d]) : 0.0f;
    dsum = __fmaf_rn(dor[i], ok ? to_f32(o[qoff + d]) : 0.0f, dsum);
    acc[i] = 0.0f;
  }
  const float delta = row_sum(dsum);
  const size_t rowoff = ((size_t)b * a.hq + h) * a.sq + row;
  const float lse = live ? a.lse[rowoff] : INFINITY;
  if (live && part == 0) a.delta[rowoff] = delta;

  // the key range any row of this tile can keep
  const int pos_lo = tile * kBwdRows + a.q_offset;
  const int pos_hi = min(tile * kBwdRows + kBwdRows, a.sq) - 1 + a.q_offset;
  const int k_lo = a.window >= 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.skv, pos_hi + 1) : a.skv;

  for (int k0 = (k_lo / kBwdTile) * kBwdTile; k0 < k_hi; k0 += kBwdTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBwdTile * DP; i += blockDim.x) {
      const int j = i / DP, d = i % DP, kp = k0 + j;
      const bool ok = kp < a.skv && d < a.d;
      const size_t off = (((size_t)b * a.skv + kp) * a.hkv + hk) * a.d + d;
      ks[j][d] = ok ? to_f32(k[off]) : 0.0f;
      vs[j][d] = ok ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kBwdTile; ++j) {
      const float s = staged_dot<DP>(ks, j, part, qr);
      const float dp = staged_dot<DP>(vs, j, part, dor);
      const float p = keeps(a, k0 + j, qpos) ? expf(__fsub_rn(s, lse)) : 0.0f;
      staged_axpy<DP>(ks, j, part, __fmul_rn(p, __fsub_rn(dp, delta)), acc);
    }
  }

  if (!live) return;
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int d = own_dim(i, part);
    if (d < a.d) dq[qoff + d] = from_f32<T>(__fmul_rn(acc[i], a.scale));
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kBwdKeys * kParts) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int kOwn = DP / kParts;  // dims a thread holds
  __shared__ __align__(16) float qs[kBwdTile][DP];  // scaled queries
  __shared__ __align__(16) float dos[kBwdTile][DP];
  __shared__ float lses[kBwdTile], deltas[kBwdTile];
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int group = a.hq / a.hkv;
  const int tile = blockIdx.y;
  const int part = threadIdx.x % kParts;
  const int key = tile * kBwdKeys + threadIdx.x / kParts;
  const bool live = key < a.skv;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  float kr[kOwn], vr[kOwn], dk[kOwn], dv[kOwn];
  const size_t koff = (((size_t)b * a.skv + (live ? key : 0)) * a.hkv + hk) * a.d;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int d = own_dim(i, part);
    const bool ok = live && d < a.d;
    kr[i] = ok ? to_f32(k[koff + d]) : 0.0f;
    vr[i] = ok ? to_f32(v[koff + d]) : 0.0f;
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  // the query rows that can keep any key of this tile
  const int j_lo = tile * kBwdKeys;
  const int j_hi = min(j_lo + kBwdKeys, a.skv) - 1;
  const int i_lo = a.causal ? max(0, j_lo - a.q_offset) : 0;
  const int i_hi = a.window >= 0 ? min(a.sq, j_hi + a.window - a.q_offset) : a.sq;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t rows = ((size_t)b * a.hq + h) * a.sq;
    for (int i0 = (i_lo / kBwdTile) * kBwdTile; i0 < i_hi; i0 += kBwdTile) {
      __syncthreads();  // the previous tile's readers are done
      for (int t = threadIdx.x; t < kBwdTile * DP; t += blockDim.x) {
        const int ii = t / DP, d = t % DP, row = i0 + ii;
        const bool ok = row < a.sq && d < a.d;
        const size_t off = (((size_t)b * a.sq + row) * a.hq + h) * a.d + d;
        qs[ii][d] = ok ? __fmul_rn(to_f32(q[off]), a.scale) : 0.0f;
        dos[ii][d] = ok ? to_f32(dout[off]) : 0.0f;
      }
      if (threadIdx.x < kBwdTile) {
        const int row = i0 + threadIdx.x;
        lses[threadIdx.x] = row < a.sq ? a.lse[rows + row] : INFINITY;
        deltas[threadIdx.x] = row < a.sq ? a.delta[rows + row] : 0.0f;
      }
      __syncthreads();
      for (int ii = 0; ii < kBwdTile; ++ii) {
        const float s = staged_dot<DP>(qs, ii, part, kr);
        const float dp = staged_dot<DP>(dos, ii, part, vr);
        const float p = keeps(a, key, i0 + ii + a.q_offset) ? expf(__fsub_rn(s, lses[ii])) : 0.0f;
        staged_axpy<DP>(dos, ii, part, p, dv);
        staged_axpy<DP>(qs, ii, part, __fmul_rn(p, __fsub_rn(dp, deltas[ii])), dk);
      }
    }
  }

  if (!live) return;
  T* dko = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int d = own_dim(i, part);
    if (d < a.d) {
      dko[koff + d] = from_f32<T>(dk[i]);
      dvo[koff + d] = from_f32<T>(dv[i]);
    }
  }
}

// ===========================================================================
// bf16 on the tensor cores: the forward (flash_fwd_mma_kernel), dq
// (flash_bwd_dq_mma_kernel) and dk/dv (flash_bwd_dkv_mma_kernel) for bf16
// inputs. The float32 kernels above stay for float32 inputs (no TF32).
//
// What bounds them. All three are bound by operations at the bf16
// tensor-core rate: at TinyLlama's shapes the forward does 2 products of
// 2 B Hq D (S^2 / 2) operations (S = Q K^T, O = P V), 1.4e11, ~0.14 ms at
// 989 TFLOP/s, against ~0.1 GB of inputs and outputs (0.03 ms); dq does 3
// (S, dP, dQ), 2.1e11, ~0.21 ms; dk/dv 4 (S^T, dP^T, dV, dK), 2.8e11,
// ~0.28 ms. At D = 64 the exponentials come
// close behind: one a (row, key) pair against 256 product operations, and
// the card's 16 exponentials a clock an SM match its tensor rate there.
//
// What the design does about it. Every product runs on
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands, float32 sums.
// A warp owns a 16-row slab of its block's rows (the forward and dq: 4
// warps, 64 query rows of one (batch, head); dk/dv: 4 warps, 64 keys of one
// (batch, KV head)), whose operand (Q; Q and dout; or K and V) it keeps in
// registers as A fragments for the whole block; dk/dv takes each staged
// tile in passes of 16 query rows, which keeps it at 164 registers and
// three blocks an SM. The other side streams through shared memory in tiles
// of 64 rows (keys and values; or queries, output gradients, lse and
// delta), copied with cp.async (16 B a thread, zero-filled past the
// sequence's end) into two stages, so the next tile's copy runs under this
// tile's products. A staged row is the head dim zero-filled to 64 (128 B);
// its eight 16-B chunks are stored XOR-swizzled by the row's low three
// bits, so the eight rows that one ldmatrix reads hit eight different bank
// groups. Operands come out of shared memory by ldmatrix (.trans where the
// staged rows are the product's k dimension: V in P V, K in dS K, dout and
// Q in dV and dK). Products that follow a softmax take their A operand from
// the accumulator fragments of the product before, rounded to bf16 in
// registers (the m16n8 C layout of two neighbouring 8-column tiles is the
// m16k16 A layout): P in P V; P^T and dS^T in dV and dK; dS in dQ = dS K. Sums, the softmax and lse stay in float32: scale
// multiplies the float32 scores (folded with log2 e into one FMA before
// each ex2), l sums the float32 p, and dQ and dK take scale in their
// float32 epilogues. dq computes delta (out . dout, float32) in its
// prologue, under the first tiles' copies, and writes it for dk/dv. A head
// dim below 64 runs D = 64's four k-steps over its zero fill: one unrolled
// body a kernel, and D < 64 is off the main path. Per-lane ldmatrix and
// cp.async addresses are worked out once, outside the tile loop. Where D
// is not a multiple of 8 or a pointer is not 16-B aligned, the tiles are
// staged with plain loads instead (the kVec flag); everything else is
// shared. Tiles outside the causal or window band are
// skipped exactly, and tiles wholly inside it skip the mask. Blocks run
// heaviest first under a causal mask. dk/dv keeps the float32 kernel's GQA
// design: a block walks every query head of its KV head's group and writes
// dk and dv once, with no atomics, so the result repeats bit for bit.
//
// At 64 < D <= 128 (qwen2-moe-a2.7b and the other D = 128 configs) all
// three run the same kernels at width 128 (the DP parameter): a staged row
// is 256 B, sixteen 16-B chunks, XOR-swizzled over their low three bits as
// at 64 (each half of a row keeps to its own eight bank groups). The
// forward's warp keeps Q as 8 k-steps of A fragments (32 registers) and O as
// 16 C fragments (64 floats). Its tiles (Q, and two stages of K and V) take
// 80 KB, past the 48 KB of static shared memory, so both widths take them as
// dynamic shared memory, and the width-128 instances raise their limit once
// (allow_smem): two blocks an SM there, against four at 64. The backward's
// accumulators double too (dq 16 C fragments; dk and dv 16 each, 128
// floats), and its held A fragments (Q and dout, or K and V: 64 registers)
// would push a thread past 255. So at width 128 neither backward kernel
// holds them: Q and dout (dq), or K and V (dk/dv), stay staged in shared
// memory of their own for the whole block, and each k-step loads its two A
// fragments by ldmatrix just before its products, the same values in the
// same order of products as the held ones. Their tiles (two stages, plus
// those) take 96 KB, two blocks an SM. Width 64 keeps its registers and its
// tiles' 33 KB, now dynamic too; its products and sums are unchanged, bit
// for bit.
// ===========================================================================
constexpr int kFwdWarps = 4;                 // forward and dq: query rows a block, 16 a warp
constexpr int kFwdRows = 16 * kFwdWarps;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kDkvKeys = 64;                  // dk/dv: keys a block, 16 a warp
constexpr int kDkvThreads = 2 * kDkvKeys;
constexpr int kDkvSub = 16;                   // dk/dv: staged query rows a pass over the registers
constexpr int kMmaTile = 64;                  // rows a staged tile holds (keys or query rows)
// the helpers below take the staged rows' width DP (bf16, zero-filled past
// the head dim) as a template parameter, 64 or 128

typedef __nv_bfloat16 bf16;

// element offset of 16-B chunk c (8 bf16) of staged row r, swizzled
template <int DP>
__device__ __forceinline__ int swz(int r, int c) { return r * DP + ((c ^ (r & 7)) << 3); }

// This lane's byte offsets into a staged tile for the two ldmatrix
// patterns. Chunk c of row r sits at r * 2 DP + ((c ^ (r & 7)) << 4); each
// pattern starts at a row that is a multiple of 8, so r & 7 is the lane's
// l7, and a k-step's chunk 2 kk + bit enters as (32 kk) ^ ((bit ^ l7) << 4).
//  - rows: lane rows l7 + 8 l16, chunk 2 kk + l8 (B, k = head dim);
//  - cols: lane rows l7 + 8 l8, chunk 2 j + l16 (A; B with k = staged rows).
struct Lanes {
  uint32_t rows, xrows, cols, xcols;
};

template <int DP>
__device__ __forceinline__ Lanes lanes() {
  const uint32_t lane = threadIdx.x & 31, l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  return Lanes{(l7 + 8 * l16) * 2 * DP, (l8 ^ l7) << 4, (l7 + 8 * l8) * 2 * DP,
               (l16 ^ l7) << 4};
}

// the A fragment of the 16 staged rows from row0 at k-step kk
template <int DP>
__device__ __forceinline__ void load_a_step(uint32_t tile, int row0, int kk, const Lanes& ln,
                                            uint32_t* a) {
  ldsm_x4(tile + row0 * 2 * DP + ln.cols + ((32 * kk) ^ ln.xcols), a);
}

// A fragments of the 16 staged rows from row0, every k-step
template <int DP>
__device__ __forceinline__ void load_a(uint32_t tile, int row0, const Lanes& ln,
                                       uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) load_a_step<DP>(tile, row0, kk, ln, a[kk]);
}

// B fragments, k = head dim (k-step kk), n = staged rows n0 .. n0 + 15 (K
// in Q K^T; Q and dout in K Q^T and V dout^T): b[0..1] for rows n0..,
// b[2..3] for n0 + 8..
template <int DP>
__device__ __forceinline__ void load_b_rows(uint32_t tile, int n0, int kk, const Lanes& ln,
                                            uint32_t* b) {
  ldsm_x4(tile + n0 * 2 * DP + ln.rows + ((32 * kk) ^ ln.xrows), b);
}

// B fragments, k = staged rows k0 .. k0 + 15, n = head dims 16 jp ..
// 16 jp + 15 (V in P V; dout and Q in dV and dK): b[0..1] for dims 16 jp..,
// b[2..3] for 16 jp + 8..
template <int DP>
__device__ __forceinline__ void load_b_cols(uint32_t tile, int k0, int jp, const Lanes& ln,
                                            uint32_t* b) {
  ldsm_x4_t(tile + k0 * 2 * DP + ln.cols + ((32 * jp) ^ ln.xcols), b);
}

// Stage rows r0 .. r0 + kRows - 1 of a [rows, stride] bf16 slice (row r at
// g + r stride) into a swizzled tile: the first d of each row's DP columns,
// rows at or past n_rows zero. kVec (d % 8 == 0, 16-B aligned rows): each
// thread copies chunk tid % (DP / 8) of every (kThreads / (DP / 8))-th row
// by cp.async, the padding chunks past d / 8 zeroed once by zero_pad; else
// plain loads of every column, zeros past d.
template <bool kVec, int kRows, int kThreads, int DP>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* g, int r0, int n_rows,
                                           size_t stride, int d) {
  constexpr int kC = DP / 8;  // 16-B chunks a row
  if (kVec) {
    const int c = threadIdx.x % kC;
    if (c < (d >> 3)) {
      const uint32_t base = smem_addr(tile);
#pragma unroll
      for (int i = 0; i < kRows * kC / kThreads; ++i) {
        const int r = threadIdx.x / kC + i * (kThreads / kC);
        const bool ok = r0 + r < n_rows;
        cp_async16(base + r * 2 * DP + ((c ^ (r & 7)) << 4),
                   ok ? g + (size_t)(r0 + r) * stride + 8 * c : g, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
      const int r = i / DP, col = i % DP;
      const bool ok = r0 + r < n_rows && col < d;
      tile[swz<DP>(r, col >> 3) + (col & 7)] =
          ok ? g[(size_t)(r0 + r) * stride + col] : __float2bfloat16(0.0f);
    }
  }
}

// zero the chunks past d / 8 of n_rows consecutive staged rows
template <int DP>
__device__ __forceinline__ void zero_pad(bf16* rows, int n_rows, int d) {
  const int cpr = d >> 3, pad = DP / 8 - cpr;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < n_rows * pad; i += blockDim.x) {
    const int r = i / pad, c = cpr + i % pad;
    *reinterpret_cast<uint4*>(rows + swz<DP>(r, c)) = make_uint4(0, 0, 0, 0);
  }
}

// store a warp's 16 x DP float32 C fragments (times mul) as bf16 rows
// row0 .. of a [rows, stride] slice, rows < n_rows, columns < d
template <bool kVec, int DP>
__device__ __forceinline__ void store_rows(bf16* g, float (*c)[4], int row0, int n_rows,
                                           size_t stride, int d, float mul0, float mul1) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + gr + 8 * half;
      const float mul = half ? mul1 : mul0;
      const float x0 = __fmul_rn(c[j][2 * half], mul), x1 = __fmul_rn(c[j][2 * half + 1], mul);
      if (row >= n_rows || col >= d) continue;
      bf16* p = g + (size_t)row * stride + col;
      if (kVec) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16(x0);
        if (col + 1 < d) p[1] = __float2bfloat16(x1);
      }
    }
  }
}

// the forward's tiles: Q [kFwdRows, DP], then two stages of K and of V
// [kMmaTile, DP], bf16
template <int DP>
constexpr size_t fwd_smem_bytes() {
  return (size_t)2 * DP * (kFwdRows + 4 * kMmaTile);
}

template <bool kVec, int DP>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_mma_kernel(FlashArgs a) {
  constexpr int kNkD = DP / 16;                 // k-steps of 16 over the head dim
  constexpr int kTileB = kMmaTile * 2 * DP;     // bytes a staged K or V tile
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_smem);  // [kFwdRows * DP]
  bf16* ks = qs + kFwdRows * DP;                 // [2][kMmaTile * DP]
  bf16* vs = ks + 2 * kMmaTile * DP;             // [2][kMmaTile * DP]
  const int b = blockIdx.x / a.hq, h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const bf16* qg = static_cast<const bf16*>(a.q) + ((size_t)b * a.sq * a.hq + h) * a.d;
  const bf16* kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.skv * a.hkv + hk) * a.d;
  const bf16* vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.skv * a.hkv + hk) * a.d;
  const size_t q_stride = (size_t)a.hq * a.d, kv_stride = (size_t)a.hkv * a.d;
  const Lanes ln = lanes<DP>();
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);

  // the key range any row of this tile can keep
  const int row_lo = tile * kFwdRows;
  const int pos_lo = row_lo + a.q_offset;
  const int pos_hi = min(row_lo + kFwdRows, a.sq) - 1 + a.q_offset;
  const int k_lo = a.window >= 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.skv, pos_hi + 1) : a.skv;
  const int k_first = (k_lo / kMmaTile) * kMmaTile;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kMmaTile - 1) / kMmaTile : 0;

  if (kVec) {
    zero_pad<DP>(qs, kFwdRows, a.d);
    zero_pad<DP>(ks, 2 * kMmaTile, a.d);
    zero_pad<DP>(vs, 2 * kMmaTile, a.d);
  }
  stage_tile<kVec, kFwdRows, kFwdThreads, DP>(qs, qg, row_lo, a.sq, q_stride, a.d);
  if (n_tiles > 0) {
    stage_tile<kVec, kMmaTile, kFwdThreads, DP>(ks, kg, k_first, a.skv, kv_stride, a.d);
    stage_tile<kVec, kMmaTile, kFwdThreads, DP>(vs, vg, k_first, a.skv, kv_stride, a.d);
  }
  cp_async_commit();

  // rows gr and gr + 8 of this warp's slab: positions, running max of the
  // raw scores, this lane's share of l, accumulator
  const int r0 = row_lo + warp * 16 + gr;
  const int qpos0 = r0 + a.q_offset, qpos1 = qpos0 + 8;
  const float scale2 = __fmul_rn(a.scale, kLog2e);  // p = 2^(scale2 (s - m))
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  float o[2 * kNkD][4];
#pragma unroll
  for (int j = 0; j < 2 * kNkD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  uint32_t qa[kNkD][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kMmaTile;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_tile<kVec, kMmaTile, kFwdThreads, DP>(ks + st * kMmaTile * DP, kg, k0 + kMmaTile,
                                                  a.skv, kv_stride, a.d);
      stage_tile<kVec, kMmaTile, kFwdThreads, DP>(vs + st * kMmaTile * DP, vg, k0 + kMmaTile,
                                                  a.skv, kv_stride, a.d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) load_a<DP>(smem_addr(qs), warp * 16, ln, qa);
    const uint32_t kt = ks_a + (it & 1) * kTileB, vt = vs_a + (it & 1) * kTileB;

    // S = Q K^T: 16 rows x 64 keys, float32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNkD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        load_b_rows<DP>(kt, 16 * jp, kk, ln, bb);
        mma16816(s[2 * jp], qa[kk], bb[0], bb[1]);
        mma16816(s[2 * jp + 1], qa[kk], bb[2], bb[3]);
      }
    }
    // masked scores are -1e30, unless the tile is inside the band for
    // every row of the block
    const bool full = k0 + kMmaTile <= a.skv && (!a.causal || k0 + kMmaTile - 1 <= pos_lo) &&
                      (a.window < 0 || k0 > pos_hi - a.window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool keep = kp < a.skv && (!a.causal || kp <= qpos) &&
                            (a.window < 0 || kp > qpos - a.window);
          s[j][e] = keep ? s[j][e] : kNeg;
        }
      }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(__fmul_rn(__fsub_rn(m0, mn0), scale2));
    const float al1 = ex2(__fmul_rn(__fsub_rn(m1, mn1), scale2));
    // p is 0 while the row's max is -1e30 (no key kept yet)
    const float off0 = mn0 > 0.5f * kNeg ? -__fmul_rn(mn0, scale2) : -INFINITY;
    const float off1 = mn1 > 0.5f * kNeg ? -__fmul_rn(mn1, scale2) : -INFINITY;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2(__fmaf_rn(s[j][0], scale2, off0));
      s[j][1] = ex2(__fmaf_rn(s[j][1], scale2, off0));
      s[j][2] = ex2(__fmaf_rn(s[j][2], scale2, off1));
      s[j][3] = ex2(__fmaf_rn(s[j][3], scale2, off1));
      ps0 = __fadd_rn(ps0, __fadd_rn(s[j][0], s[j][1]));
      ps1 = __fadd_rn(ps1, __fadd_rn(s[j][2], s[j][3]));
    }
    // l sums the float32 p; only P V takes p in bf16
    l0 = __fmaf_rn(l0, al0, ps0);
    l1 = __fmaf_rn(l1, al1, ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 2 * kNkD; ++j) {
      o[j][0] = __fmul_rn(o[j][0], al0);
      o[j][1] = __fmul_rn(o[j][1], al0);
      o[j][2] = __fmul_rn(o[j][2], al1);
      o[j][3] = __fmul_rn(o[j][3], al1);
    }
    // O += P V: P from the score fragments, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      c_to_a(s, kk, pa);
#pragma unroll
      for (int jp = 0; jp < kNkD; ++jp) {
        uint32_t bb[4];
        load_b_cols<DP>(vt, 16 * kk, jp, ln, bb);
        mma16816(o[2 * jp], pa, bb[0], bb[1]);
        mma16816(o[2 * jp + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // l over the row's quad; out = acc / l (0 where l = 0), lse = +inf there
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  const float inv0 = l0 > 0.0f ? __fdiv_rn(1.0f, l0) : 0.0f;
  const float inv1 = l1 > 0.0f ? __fdiv_rn(1.0f, l1) : 0.0f;
  store_rows<kVec, DP>(static_cast<bf16*>(a.out) + ((size_t)b * a.sq * a.hq + h) * a.d, o,
                        row_lo + warp * 16, a.sq, q_stride, a.d, inv0, inv1);
  if (t == 0) {
    float* lse = a.lse + ((size_t)b * a.hq + h) * a.sq;
    if (r0 < a.sq) lse[r0] = l0 > 0.0f ? __fmaf_rn(m0, a.scale, logf(l0)) : INFINITY;
    if (r0 + 8 < a.sq) lse[r0 + 8] = l1 > 0.0f ? __fmaf_rn(m1, a.scale, logf(l1)) : INFINITY;
  }
}

// The backward's tiles (dynamic shared memory). At width 64 (kHold: DP <=
// kNarrow) each warp keeps its block's operand rows (Q and dout, or K and V)
// as A fragments in registers, staged once through the second stage; at
// width 128 they keep their own staged tiles and are loaded a k-step at a
// time.

// dq: two stages of K and of V [kMmaTile, DP], then (width 128) Q and dout
// [kFwdRows, DP], bf16; delta [kFwdRows] float32
template <int DP>
constexpr size_t dq_smem_bytes() {
  return (size_t)2 * DP * (4 * kMmaTile + (DP <= kNarrow ? 0 : 2 * kFwdRows)) +
         4 * kFwdRows;
}

// dk/dv: two stages of Q and of dout [kMmaTile, DP], then (width 128) K and V
// [kDkvKeys, DP], bf16; two stages of lse and of delta [kMmaTile] float32
template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (size_t)2 * DP * (4 * kMmaTile + (DP <= kNarrow ? 0 : 2 * kDkvKeys)) +
         4 * 4 * kMmaTile;
}

// dk/dv: stage query rows i0 .. i0 + 63 of head h (q, dout, lse, delta);
// lse and delta are 0 past Sq, where the mask keeps nothing
template <bool kVec, int DP>
__device__ __forceinline__ void stage_rows(const BwdArgs& a, bf16* qt, bf16* dt, float* lt,
                                           float* det, int b, int h, int i0) {
  const size_t q_off = ((size_t)b * a.sq * a.hq + h) * a.d, q_stride = (size_t)a.hq * a.d;
  stage_tile<kVec, kMmaTile, kDkvThreads, DP>(qt, static_cast<const bf16*>(a.q) + q_off, i0,
                                              a.sq, q_stride, a.d);
  stage_tile<kVec, kMmaTile, kDkvThreads, DP>(dt, static_cast<const bf16*>(a.dout) + q_off, i0,
                                              a.sq, q_stride, a.d);
  if (threadIdx.x < kMmaTile) {
    const int row = i0 + threadIdx.x;
    const bool ok = row < a.sq;
    const size_t at = ok ? ((size_t)b * a.hq + h) * a.sq + row : 0;
    cp_async4(smem_addr(lt + threadIdx.x), a.lse + at, ok);
    cp_async4(smem_addr(det + threadIdx.x), a.delta + at, ok);
  }
}

template <bool kVec, int DP>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_dkv_mma_kernel(BwdArgs a) {
  constexpr int kNkD = DP / 16;             // k-steps of 16 over the head dim
  constexpr bool kHold = DP <= kNarrow;
  constexpr int kTileE = kMmaTile * DP;     // elements of a staged tile
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);  // [2][kTileE]
  bf16* dos = qs + 2 * kTileE;                    // [2][kTileE]
  bf16* kvs = dos + 2 * kTileE;                   // width 128: K, V [kDkvKeys * DP] each
  float* lses = reinterpret_cast<float*>(kvs + (kHold ? 0 : 2 * kDkvKeys * DP));  // [2][kMmaTile]
  float* dels = lses + 2 * kMmaTile;              // [2][kMmaTile]
  // K and V of the block's keys: through stage 0 into registers (kHold), or
  // in their own tiles
  bf16* kst = kHold ? qs : kvs;
  bf16* vst = kHold ? dos : kvs + kDkvKeys * DP;
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int group = a.hq / a.hkv;
  const int tile = blockIdx.y;  // under a causal mask the first key tiles see the most rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const size_t kv_stride = (size_t)a.hkv * a.d;
  const size_t kv_off = ((size_t)b * a.skv * a.hkv + hk) * a.d;
  const Lanes ln = lanes<DP>();
  const uint32_t qs_a = smem_addr(qs), dos_a = smem_addr(dos);
  const uint32_t ks_a = smem_addr(kst), vs_a = smem_addr(vst);

  // the query rows that can keep any key of this tile
  const int j_lo = tile * kDkvKeys;
  const int j_hi = min(j_lo + kDkvKeys, a.skv) - 1;
  const int i_lo = a.causal ? max(0, j_lo - a.q_offset) : 0;
  const int i_hi = a.window >= 0 ? min(a.sq, j_hi + a.window - a.q_offset) : a.sq;
  const int i_first = (i_lo / kMmaTile) * kMmaTile;
  const int n_qt = i_hi > i_first ? (i_hi - i_first + kMmaTile - 1) / kMmaTile : 0;
  const int n_it = group * n_qt;

  if (kVec) {
    zero_pad<DP>(qs, 2 * kMmaTile, a.d);
    zero_pad<DP>(dos, 2 * kMmaTile, a.d);
    if (!kHold) zero_pad<DP>(kvs, 2 * kDkvKeys, a.d);
  }
  stage_tile<kVec, kMmaTile, kDkvThreads, DP>(kst, static_cast<const bf16*>(a.k) + kv_off, j_lo,
                                              a.skv, kv_stride, a.d);
  stage_tile<kVec, kMmaTile, kDkvThreads, DP>(vst, static_cast<const bf16*>(a.v) + kv_off, j_lo,
                                              a.skv, kv_stride, a.d);
  cp_async_commit();
  uint32_t ka[kHold ? kNkD : 1][4], va[kHold ? kNkD : 1][4];
  if constexpr (kHold) {
    cp_async_wait<0>();
    __syncthreads();
    load_a<DP>(ks_a, warp * 16, ln, ka);
    load_a<DP>(vs_a, warp * 16, ln, va);
    __syncthreads();
  }

  float dk[2 * kNkD][4], dv[2 * kNkD][4];
#pragma unroll
  for (int j = 0; j < 2 * kNkD; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
  }
  const float scale2 = __fmul_rn(a.scale, kLog2e);
  const int key0 = j_lo + warp * 16 + gr;  // this lane's keys: key0, key0 + 8

  if (n_it > 0) stage_rows<kVec, DP>(a, qs, dos, lses, dels, b, hk * group, i_first);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      const int nx = st ^ 1;
      stage_rows<kVec, DP>(a, qs + nx * kTileE, dos + nx * kTileE, lses + nx * kMmaTile,
                           dels + nx * kMmaTile, b, hk * group + (it + 1) / n_qt,
                           i_first + ((it + 1) % n_qt) * kMmaTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = i_first + (it % n_qt) * kMmaTile;
    const float* lse_t = lses + st * kMmaTile;
    const float* del_t = dels + st * kMmaTile;
    // every pair of the block's keys and the tile's rows is kept: no mask
    const bool full = i0 + kMmaTile <= a.sq && j_hi == j_lo + kDkvKeys - 1 &&
                      (!a.causal || j_hi <= i0 + a.q_offset) &&
                      (a.window < 0 || j_lo > i0 + kMmaTile - 1 + a.q_offset - a.window);
    const uint32_t qt = qs_a + st * 2 * kTileE, dt = dos_a + st * 2 * kTileE;
    // the tile's rows in passes of kDkvSub
#pragma unroll
    for (int pass = 0; pass < kMmaTile / kDkvSub; ++pass) {
      const int c0 = kDkvSub * pass;  // first staged row of this pass
      // S^T = K Q^T and dP^T = V dout^T: 16 keys x kDkvSub rows, float32
      float s[kDkvSub / 8][4], dp[kDkvSub / 8][4];
#pragma unroll
      for (int j = 0; j < kDkvSub / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kNkD; ++kk) {
        uint32_t kf[4], vf[4];
        const uint32_t* kak = kf;
        const uint32_t* vak = vf;
        if constexpr (kHold) {
          kak = ka[kk];
          vak = va[kk];
        } else {
          load_a_step<DP>(ks_a, warp * 16, kk, ln, kf);
          load_a_step<DP>(vs_a, warp * 16, kk, ln, vf);
        }
#pragma unroll
        for (int jp = 0; jp < kDkvSub / 16; ++jp) {
          uint32_t bb[4];
          load_b_rows<DP>(qt, c0 + 16 * jp, kk, ln, bb);
          mma16816(s[2 * jp], kak, bb[0], bb[1]);
          mma16816(s[2 * jp + 1], kak, bb[2], bb[3]);
          load_b_rows<DP>(dt, c0 + 16 * jp, kk, ln, bb);
          mma16816(dp[2 * jp], vak, bb[0], bb[1]);
          mma16816(dp[2 * jp + 1], vak, bb[2], bb[3]);
        }
      }
      // P^T = exp(scale S^T - lse) where kept, dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < kDkvSub / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 8 * j + 2 * t + c;
          const float lse2 = __fmul_rn(lse_t[col], kLog2e), del = del_t[col];
          const int row = i0 + col, qpos = row + a.q_offset;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int e = 2 * rr + c, key = key0 + 8 * rr;
            float p = ex2(__fmaf_rn(s[j][e], scale2, -lse2));
            if (!full) {
              const bool keep = row < a.sq && key < a.skv && (!a.causal || key <= qpos) &&
                                (a.window < 0 || key > qpos - a.window);
              p = keep ? p : 0.0f;
            }
            s[j][e] = p;
            dp[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], del));
          }
        }
      }
      // dV += P^T dout and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
      for (int kq = 0; kq < kDkvSub / 16; ++kq) {
        uint32_t pa[4], da[4];
        c_to_a(s, kq, pa);
        c_to_a(dp, kq, da);
#pragma unroll
        for (int jp = 0; jp < kNkD; ++jp) {
          uint32_t bb[4];
          load_b_cols<DP>(dt, c0 + 16 * kq, jp, ln, bb);
          mma16816(dv[2 * jp], pa, bb[0], bb[1]);
          mma16816(dv[2 * jp + 1], pa, bb[2], bb[3]);
          load_b_cols<DP>(qt, c0 + 16 * kq, jp, ln, bb);
          mma16816(dk[2 * jp], da, bb[0], bb[1]);
          mma16816(dk[2 * jp + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // dk takes scale in float32; both written once, in bf16
  store_rows<kVec, DP>(static_cast<bf16*>(a.dk) + kv_off, dk, j_lo + warp * 16, a.skv,
                       kv_stride, a.d, a.scale, a.scale);
  store_rows<kVec, DP>(static_cast<bf16*>(a.dv) + kv_off, dv, j_lo + warp * 16, a.skv,
                       kv_stride, a.d, 1.0f, 1.0f);
}

// dq: a block per (batch, query head, 64 query rows), a warp per 16 rows.
// Q and dout are staged once (at width 64 through the second K/V stage and
// kept as A fragments; at 128 in their own tiles); delta (out . dout in
// float32) is written for dk/dv; K and V stream through the two stages. Per
// tile: S = Q K^T and dP = dout V^T, P = ex2(scale log2e S - log2e lse)
// where kept, dS = P (dP - delta) in float32, then dQ += dS K with dS
// rounded to bf16 from its C fragments.
template <bool kVec, int DP>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dq_mma_kernel(BwdArgs a) {
  constexpr int kNkD = DP / 16;             // k-steps of 16 over the head dim
  constexpr bool kHold = DP <= kNarrow;
  constexpr int kTileE = kMmaTile * DP;     // elements of a staged tile
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // [2][kTileE]
  bf16* vs = ks + 2 * kTileE;                     // [2][kTileE]
  bf16* qs = kHold ? ks + kTileE : vs + 2 * kTileE;       // [kFwdRows * DP]
  bf16* dos = kHold ? vs + kTileE : qs + kFwdRows * DP;   // [kFwdRows * DP]
  float* dels = reinterpret_cast<float*>(vs + 2 * kTileE + (kHold ? 0 : 2 * kFwdRows * DP));
  const int b = blockIdx.x / a.hq, h = blockIdx.x % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const size_t q_off = ((size_t)b * a.sq * a.hq + h) * a.d, q_stride = (size_t)a.hq * a.d;
  const bf16* kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.skv * a.hkv + hk) * a.d;
  const bf16* vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.skv * a.hkv + hk) * a.d;
  const size_t kv_stride = (size_t)a.hkv * a.d;
  const Lanes ln = lanes<DP>();
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);
  const uint32_t qs_a = smem_addr(qs), dos_a = smem_addr(dos);

  // the key range any row of this tile can keep
  const int row_lo = tile * kFwdRows;
  const int pos_lo = row_lo + a.q_offset;
  const int pos_hi = min(row_lo + kFwdRows, a.sq) - 1 + a.q_offset;
  const int k_lo = a.window >= 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.skv, pos_hi + 1) : a.skv;
  const int k_first = (k_lo / kMmaTile) * kMmaTile;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kMmaTile - 1) / kMmaTile : 0;

  if (kVec) {
    zero_pad<DP>(ks, 2 * kMmaTile, a.d);
    zero_pad<DP>(vs, 2 * kMmaTile, a.d);
    if (!kHold) zero_pad<DP>(qs, 2 * kFwdRows, a.d);  // Q and dout, consecutive
  }
  // Q and dout, the first K/V tile into stage 0
  stage_tile<kVec, kFwdRows, kFwdThreads, DP>(qs, static_cast<const bf16*>(a.q) + q_off, row_lo,
                                              a.sq, q_stride, a.d);
  stage_tile<kVec, kFwdRows, kFwdThreads, DP>(dos, static_cast<const bf16*>(a.dout) + q_off,
                                              row_lo, a.sq, q_stride, a.d);
  if (n_tiles > 0) {
    stage_tile<kVec, kMmaTile, kFwdThreads, DP>(ks, kg, k_first, a.skv, kv_stride, a.d);
    stage_tile<kVec, kMmaTile, kFwdThreads, DP>(vs, vg, k_first, a.skv, kv_stride, a.d);
  }
  cp_async_commit();

  // delta of row threadIdx / 2 over half its dims, under the copies
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = row_lo + r;
    float dsum = 0.0f;
    if (row < a.sq) {
      const size_t off = q_off + (size_t)row * q_stride;
      const bf16* o = static_cast<const bf16*>(a.out) + off;
      const bf16* dout = static_cast<const bf16*>(a.dout) + off;
#pragma unroll 8
      for (int c = (DP / 2) * half; c < min((DP / 2) * (half + 1), a.d); ++c) {
        dsum = __fmaf_rn(__bfloat162float(o[c]), __bfloat162float(dout[c]), dsum);
      }
    }
    dsum = __fadd_rn(dsum, __shfl_xor_sync(kFull, dsum, 1));
    if (half == 0) {
      dels[r] = dsum;
      if (row < a.sq) a.delta[((size_t)b * a.hq + h) * a.sq + row] = dsum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kHold ? kNkD : 1][4], da[kHold ? kNkD : 1][4];
  if constexpr (kHold) {
    load_a<DP>(qs_a, warp * 16, ln, qa);
    load_a<DP>(dos_a, warp * 16, ln, da);
  }

  // rows r0 and r0 + 8 of this warp's slab: positions, lse and delta (rows
  // past Sq: lse +inf, so p = 0)
  const int r0 = row_lo + warp * 16 + gr;
  const int qpos0 = r0 + a.q_offset, qpos1 = qpos0 + 8;
  const float* lse = a.lse + ((size_t)b * a.hq + h) * a.sq;
  const float nl0 = r0 < a.sq ? -__fmul_rn(lse[r0], kLog2e) : -INFINITY;
  const float nl1 = r0 + 8 < a.sq ? -__fmul_rn(lse[r0 + 8], kLog2e) : -INFINITY;
  const float del0 = dels[warp * 16 + gr], del1 = dels[warp * 16 + gr + 8];
  const float scale2 = __fmul_rn(a.scale, kLog2e);
  float dq[2 * kNkD][4];
#pragma unroll
  for (int j = 0; j < 2 * kNkD; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
  __syncthreads();  // stage 1 is free for the next tile

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kMmaTile;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_tile<kVec, kMmaTile, kFwdThreads, DP>(ks + st * kTileE, kg, k0 + kMmaTile, a.skv,
                                                  kv_stride, a.d);
      stage_tile<kVec, kMmaTile, kFwdThreads, DP>(vs + st * kTileE, vg, k0 + kMmaTile, a.skv,
                                                  kv_stride, a.d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kt = ks_a + (it & 1) * 2 * kTileE, vt = vs_a + (it & 1) * 2 * kTileE;

    // S = Q K^T and dP = dout V^T: 16 rows x 64 keys, float32
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kNkD; ++kk) {
      uint32_t qf[4], df[4];
      const uint32_t* qak = qf;
      const uint32_t* dak = df;
      if constexpr (kHold) {
        qak = qa[kk];
        dak = da[kk];
      } else {
        load_a_step<DP>(qs_a, warp * 16, kk, ln, qf);
        load_a_step<DP>(dos_a, warp * 16, kk, ln, df);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        load_b_rows<DP>(kt, 16 * jp, kk, ln, bb);
        mma16816(s[2 * jp], qak, bb[0], bb[1]);
        mma16816(s[2 * jp + 1], qak, bb[2], bb[3]);
        load_b_rows<DP>(vt, 16 * jp, kk, ln, bb);
        mma16816(dp[2 * jp], dak, bb[0], bb[1]);
        mma16816(dp[2 * jp + 1], dak, bb[2], bb[3]);
      }
    }
    // P = exp(scale S - lse) where kept (the mask only where the tile is not
    // inside the band for every row), dS = P (dP - delta)
    const bool full = k0 + kMmaTile <= a.skv && (!a.causal || k0 + kMmaTile - 1 <= pos_lo) &&
                      (a.window < 0 || k0 > pos_hi - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float p = ex2(__fmaf_rn(s[j][e], scale2, hi ? nl1 : nl0));
        if (!full) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = hi ? qpos1 : qpos0;
          const bool keep = kp < a.skv && (!a.causal || kp <= qpos) &&
                            (a.window < 0 || kp > qpos - a.window);
          p = keep ? p : 0.0f;
        }
        s[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], hi ? del1 : del0));
      }
    }
    // dQ += dS K: dS rounded to bf16 from the score fragments, K by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dsa[4];
      c_to_a(s, kk, dsa);
#pragma unroll
      for (int jp = 0; jp < kNkD; ++jp) {
        uint32_t bb[4];
        load_b_cols<DP>(kt, 16 * kk, jp, ln, bb);
        mma16816(dq[2 * jp], dsa, bb[0], bb[1]);
        mma16816(dq[2 * jp + 1], dsa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // dq takes scale in float32, written once in bf16
  store_rows<kVec, DP>(static_cast<bf16*>(a.dq) + q_off, dq, row_lo + warp * 16, a.sq, q_stride,
                       a.d, a.scale, a.scale);
}

// cp.async and the paired stores need d % 8 == 0 and 16-B aligned bases
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A kernel whose tiles pass 48 KB needs its dynamic shared memory limit
// raised, once an instance (*done records it).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024 || *done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

template <bool kVec, int DP>
int fwd_mma_prepare() {
  static bool done = false;
  return allow_smem(flash_fwd_mma_kernel<kVec, DP>, fwd_smem_bytes<DP>(), &done);
}

template <bool kVec, int DP>
int dq_mma_prepare() {
  static bool done = false;
  return allow_smem(flash_bwd_dq_mma_kernel<kVec, DP>, dq_smem_bytes<DP>(), &done);
}

template <bool kVec, int DP>
int dkv_mma_prepare() {
  static bool done = false;
  return allow_smem(flash_bwd_dkv_mma_kernel<kVec, DP>, dkv_smem_bytes<DP>(), &done);
}

template <bool kVec, int DP>
int launch_fwd_mma(const FlashArgs& a, int batch, cudaStream_t stream) {
  const int err = fwd_mma_prepare<kVec, DP>();
  if (err != 0) return err;
  const dim3 grid(batch * a.hq, (a.sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_mma_kernel<kVec, DP><<<grid, kFwdThreads, fwd_smem_bytes<DP>(), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd(const FlashArgs& a, int batch, int dtype, bool vec, cudaStream_t stream) {
  if (dtype == 0) return launch<float, DP>(a, batch, stream);
  return vec ? launch_fwd_mma<true, DP>(a, batch, stream)
             : launch_fwd_mma<false, DP>(a, batch, stream);
}

template <bool kVec, int DP>
int launch_dq_mma(const BwdArgs& a, int batch, cudaStream_t s) {
  const int err = dq_mma_prepare<kVec, DP>();
  if (err != 0) return err;
  const dim3 grid(batch * a.hq, (a.sq + kFwdRows - 1) / kFwdRows);
  flash_bwd_dq_mma_kernel<kVec, DP><<<grid, kFwdThreads, dq_smem_bytes<DP>(), s>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const BwdArgs& a, int batch, int dtype, bool vec, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid(batch * a.hq, (a.sq + kBwdRows - 1) / kBwdRows);
    flash_bwd_dq_kernel<float, DP><<<grid, kBwdRows * kParts, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  return vec ? launch_dq_mma<true, DP>(a, batch, s) : launch_dq_mma<false, DP>(a, batch, s);
}

template <bool kVec, int DP>
int launch_dkv_mma(const BwdArgs& a, int batch, cudaStream_t s) {
  const int err = dkv_mma_prepare<kVec, DP>();
  if (err != 0) return err;
  const dim3 grid(batch * a.hkv, (a.skv + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv_mma_kernel<kVec, DP><<<grid, kDkvThreads, dkv_smem_bytes<DP>(), s>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const BwdArgs& a, int batch, int dtype, bool vec, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid(batch * a.hkv, (a.skv + kBwdKeys - 1) / kBwdKeys);
    flash_bwd_dkv_kernel<float, DP><<<grid, kBwdKeys * kParts, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  return vec ? launch_dkv_mma<true, DP>(a, batch, s) : launch_dkv_mma<false, DP>(a, batch, s);
}

bool bwd_shape_ok(int batch, int sq, int skv, int hq, int hkv, int d, int dtype) {
  return batch >= 1 && sq >= 1 && skv >= 1 && hkv >= 1 && hq % hkv == 0 && d >= 1 &&
         d <= kMaxD && (dtype == 0 || dtype == 1) && (long long)batch * hq <= 0x7fffffffLL &&
         (sq + kBwdRows - 1) / kBwdRows <= 65535 && (skv + kBwdKeys - 1) / kBwdKeys <= 65535;
}

}  // namespace

extern "C" {

// Largest head dims the forward and the backward take (both 128).
int flash_attention_limits(int* max_d_fwd, int* max_d_bwd) {
  *max_d_fwd = kMaxD;
  *max_d_bwd = kMaxD;
  return 0;
}

// Blocks an SM holds of the bf16 tensor-core kernels (cp.async builds):
// the forward, dq and dk/dv, each at widths 64 and 128 (out[0..5] in that
// order). Returns a cudaError_t.
int flash_attention_mma_occupancy(int* out) {
  int err = fwd_mma_prepare<true, kMaxD>();
  if (err == 0) err = dq_mma_prepare<true, kMaxD>();
  if (err == 0) err = dkv_mma_prepare<true, kMaxD>();
  const struct {
    const void* fn;
    int threads;
    size_t smem;
  } kernels[6] = {
      {(const void*)flash_fwd_mma_kernel<true, kNarrow>, kFwdThreads, fwd_smem_bytes<kNarrow>()},
      {(const void*)flash_fwd_mma_kernel<true, kMaxD>, kFwdThreads, fwd_smem_bytes<kMaxD>()},
      {(const void*)flash_bwd_dq_mma_kernel<true, kNarrow>, kFwdThreads, dq_smem_bytes<kNarrow>()},
      {(const void*)flash_bwd_dq_mma_kernel<true, kMaxD>, kFwdThreads, dq_smem_bytes<kMaxD>()},
      {(const void*)flash_bwd_dkv_mma_kernel<true, kNarrow>, kDkvThreads,
       dkv_smem_bytes<kNarrow>()},
      {(const void*)flash_bwd_dkv_mma_kernel<true, kMaxD>, kDkvThreads, dkv_smem_bytes<kMaxD>()},
  };
  for (int i = 0; i < 6 && err == 0; ++i) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i, kernels[i].fn,
                                                             kernels[i].threads, kernels[i].smem);
  }
  return err;
}

// dtype: 0 float32 (flash_fwd_kernel), 1 bfloat16 (flash_fwd_mma_kernel);
// d <= 64 runs the width-64 instances, 64 < d <= 128 the width-128 ones.
// window < 0: none. Returns a cudaError_t.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               float* lse, int batch, int sq, int skv, int hq, int hkv,
                               int d, int causal, int window, int q_offset, float scale,
                               int dtype, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv != 0 || d < 1 || d > kMaxD ||
      (dtype != 0 && dtype != 1) || batch > 65535 || hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 &&
      ((long long)batch * hq > 0x7fffffffLL || (sq + kFwdRows - 1) / kFwdRows > 65535)) {
    return (int)cudaErrorInvalidValue;
  }
  FlashArgs a{q, k, v, out, lse, sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  return d <= kNarrow ? launch_fwd<kNarrow>(a, batch, dtype, vec, s)
                      : launch_fwd<kMaxD>(a, batch, dtype, vec, s);
}

// The backward's first kernel: dq, and delta for the second. dtype: 0
// float32 (flash_bwd_dq_kernel), 1 bfloat16 (flash_bwd_dq_mma_kernel); d <=
// 64 runs the width-64 instances, 64 < d <= 128 the width-128 ones. window <
// 0: none. Returns a cudaError_t.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* out, const void* dout, const float* lse,
                                  float* delta, void* dq, int batch, int sq, int skv, int hq,
                                  int hkv, int d, int causal, int window, int q_offset,
                                  float scale, int dtype, void* stream) {
  if (!bwd_shape_ok(batch, sq, skv, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr,
            sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && aligned16(dq);
  return d <= kNarrow ? launch_dq<kNarrow>(a, batch, dtype, vec, s)
                      : launch_dq<kMaxD>(a, batch, dtype, vec, s);
}

// The backward's second kernel: dk and dv from delta, which the dq kernel
// wrote; launch it after that one on the same stream. dtype: 0 float32
// (flash_bwd_dkv_kernel), 1 bfloat16 (flash_bwd_dkv_mma_kernel); widths as
// dq's. Returns a cudaError_t.
int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int batch, int sq, int skv, int hq,
                                   int hkv, int d, int causal, int window, int q_offset,
                                   float scale, int dtype, void* stream) {
  if (!bwd_shape_ok(batch, sq, skv, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
            sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && aligned16(dk) && aligned16(dv);
  return d <= kNarrow ? launch_dkv<kNarrow>(a, batch, dtype, vec, s)
                      : launch_dkv<kMaxD>(a, batch, dtype, vec, s);
}

}  // extern "C"
