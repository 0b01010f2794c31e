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

// The backward (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) follows below,
// with its own note.

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
// What the design does about it. These first kernels are the simple kind,
// float32 fused multiply-adds on the CUDA cores (no tensor cores yet), so
// the 67 TFLOP/s fp32 rate is their ceiling. A row carries three (dq) or four
// (dk/dv) head-dim vectors; one thread a row, as the forward has, would take
// ~200 registers for them alone and spill. So four neighbouring threads share
// a row, each holding 16 of its 64 dims, and the dot products s and dp are
// finished with two butterfly shuffles, which leave the same sum in all four
// lanes. A thread's 16 dims are four float4 chunks strided by four, so the
// four threads of a row read 64 consecutive bytes of a staged row from shared
// memory, free of bank conflicts.
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
constexpr int kChunks = kMaxD / 4 / kParts;    // float4 chunks a thread holds
constexpr int kOwn = 4 * kChunks;              // dims a thread holds (16)
constexpr int kBwdRows = 64;                   // dq: query rows a block
constexpr int kBwdKeys = 64;                   // dk/dv: keys a block
constexpr int kBwdTile = 32;                   // staged keys (dq) or query rows (dk/dv)
constexpr unsigned kFull = 0xffffffffu;

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

// staged rows [kBwdTile][kMaxD] of a: the 16 dims of this thread's part
// dotted with x, finished over the row's lanes
__device__ __forceinline__ float staged_dot(const float (*rows)[kMaxD], int j, int part,
                                            const float* x) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(&rows[j][4 * (c * kParts + part)]);
    acc = __fmaf_rn(x[4 * c], y.x, acc);
    acc = __fmaf_rn(x[4 * c + 1], y.y, acc);
    acc = __fmaf_rn(x[4 * c + 2], y.z, acc);
    acc = __fmaf_rn(x[4 * c + 3], y.w, acc);
  }
  return row_sum(acc);
}

// acc += w * rows[j] over this thread's 16 dims
__device__ __forceinline__ void staged_axpy(const float (*rows)[kMaxD], int j, int part,
                                            float w, float* acc) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
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

template <typename T>
__global__ void __launch_bounds__(kBwdRows * kParts) flash_bwd_dq_kernel(BwdArgs a) {
  __shared__ __align__(16) float ks[kBwdTile][kMaxD];
  __shared__ __align__(16) float vs[kBwdTile][kMaxD];
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
    for (int i = threadIdx.x; i < kBwdTile * kMaxD; i += blockDim.x) {
      const int j = i / kMaxD, d = i % kMaxD, kp = k0 + j;
      const bool ok = kp < a.skv && d < a.d;
      const size_t off = (((size_t)b * a.skv + kp) * a.hkv + hk) * a.d + d;
      ks[j][d] = ok ? to_f32(k[off]) : 0.0f;
      vs[j][d] = ok ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kBwdTile; ++j) {
      const float s = staged_dot(ks, j, part, qr);
      const float dp = staged_dot(vs, j, part, dor);
      const float p = keeps(a, k0 + j, qpos) ? expf(__fsub_rn(s, lse)) : 0.0f;
      staged_axpy(ks, j, part, __fmul_rn(p, __fsub_rn(dp, delta)), acc);
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

template <typename T>
__global__ void __launch_bounds__(kBwdKeys * kParts) flash_bwd_dkv_kernel(BwdArgs a) {
  __shared__ __align__(16) float qs[kBwdTile][kMaxD];  // scaled queries
  __shared__ __align__(16) float dos[kBwdTile][kMaxD];
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
      for (int t = threadIdx.x; t < kBwdTile * kMaxD; t += blockDim.x) {
        const int ii = t / kMaxD, d = t % kMaxD, row = i0 + ii;
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
        const float s = staged_dot(qs, ii, part, kr);
        const float dp = staged_dot(dos, ii, part, vr);
        const float p = keeps(a, key, i0 + ii + a.q_offset) ? expf(__fsub_rn(s, lses[ii])) : 0.0f;
        staged_axpy(dos, ii, part, p, dv);
        staged_axpy(qs, ii, part, __fmul_rn(p, __fsub_rn(dp, deltas[ii])), dk);
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

bool bwd_shape_ok(int batch, int sq, int skv, int hq, int hkv, int d, int dtype) {
  return batch >= 1 && sq >= 1 && skv >= 1 && hkv >= 1 && hq % hkv == 0 && d >= 1 &&
         d <= kMaxD && (dtype == 0 || dtype == 1) && (long long)batch * hq <= 0x7fffffffLL &&
         (sq + kBwdRows - 1) / kBwdRows <= 65535 && (skv + kBwdKeys - 1) / kBwdKeys <= 65535;
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

// The backward's first kernel: dq, and delta for the second. dtype: 0
// float32, 1 bfloat16. window < 0: none. Returns a cudaError_t.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* out, const void* dout, const float* lse,
                                  float* delta, void* dq, int batch, int sq, int skv, int hq,
                                  int hkv, int d, int causal, int window, int q_offset,
                                  float scale, int dtype, void* stream) {
  if (!bwd_shape_ok(batch, sq, skv, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr,
            sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  const dim3 grid(batch * hq, (sq + kBwdRows - 1) / kBwdRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_bwd_dq_kernel<float><<<grid, kBwdRows * kParts, 0, s>>>(a);
  } else {
    flash_bwd_dq_kernel<__nv_bfloat16><<<grid, kBwdRows * kParts, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The backward's second kernel: dk and dv from delta, which the dq kernel
// wrote; launch it after that one on the same stream. Returns a cudaError_t.
int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int batch, int sq, int skv, int hq,
                                   int hkv, int d, int causal, int window, int q_offset,
                                   float scale, int dtype, void* stream) {
  if (!bwd_shape_ok(batch, sq, skv, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
            sq, skv, hq, hkv, d, causal, window, q_offset, scale};
  const dim3 grid(batch * hkv, (skv + kBwdKeys - 1) / kBwdKeys);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_bwd_dkv_kernel<float><<<grid, kBwdKeys * kParts, 0, s>>>(a);
  } else {
    flash_bwd_dkv_kernel<__nv_bfloat16><<<grid, kBwdKeys * kParts, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
