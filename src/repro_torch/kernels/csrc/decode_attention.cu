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
// What the design does about it. One block per (batch, KV head) would be 40
// blocks on 132 SMs at B = 8, so the positions are split over the grid
// (split-S): the grid is (splits, Hkv, B), and the host picks splits from S,
// B Hkv and the card's resident blocks (the kernel's blocks an SM from the
// occupancy calculator, times the SM count) so that the grid fills them in
// one wave. A split owns a contiguous range of positions, a multiple of the
// block's step; positions at or past lengths[b] are not read (they contribute
// p = 0), and a split wholly past it writes an empty partial. As on the TPU,
// the G query heads of a KV group are served together, so each cache row is
// read once for the whole group; the group's size is compiled in (1, 2, 4, 5
// or 8, padded up), so the loops over it unroll. A lane loads 16 B of a row
// (8 bf16 or 4 float32), so at D = 64 in bf16 a row is 8 lanes and a warp
// reads 4 positions a load, 4 loads a step of K and of V; the first step's
// loads are issued before q is staged. Each dot product is finished over the
// row's lanes by butterfly shuffles (3 at 8 lanes). Where D is not a multiple
// of a lane's width or a pointer is off 16 B, the same lanes load element by
// element. Each lane-row keeps an online softmax (max, normaliser,
// accumulator) per query head over its positions, in the log2 domain (q is
// scaled by scale log2 e once); these are merged across the warp by shuffles,
// across the block's warps in shared memory, and written as the split's
// float32 partial (m, l, acc[G][D]) to a workspace. The merge runs in the
// same launch: each block fences its partial and takes a ticket on its
// (batch, KV head) counter; the last one to finish merges every split (at
// most 64) in split order, so the result repeats bit for bit: the splits'
// weights 2^(m - max) go through shared memory, and each output's loads of
// the splits' acc issue together. It writes out and resets the counter to 0
// for the next launch. The wrapper allocates the workspace and keeps the
// zeroed counters, one buffer a device, so launches that share a device run
// in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;      // rows a lane loads per step, each of K and V
constexpr int kMaxSplits = 64;
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 B of a row, elements e0 .. (zeros at and past d): one vector load, or
// element by element where the row is not 16-B aligned or d is not a
// multiple of the lane's width
__device__ __forceinline__ uint4 load16(const float* row, int e0, int d, bool vec) {
  if (vec) return e0 < d ? __ldg(reinterpret_cast<const uint4*>(row + e0)) : make_uint4(0, 0, 0, 0);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = e0 + e < d ? __float_as_uint(row[e0 + e]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* row, int e0, int d, bool vec) {
  if (vec) return e0 < d ? __ldg(reinterpret_cast<const uint4*>(row + e0)) : make_uint4(0, 0, 0, 0);
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = e0 + 2 * i < d ? r[e0 + 2 * i] : 0u;
    const uint32_t hi = e0 + 2 * i + 1 < d ? r[e0 + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// element e of a 16-B chunk as float32
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// the sum over a row's LPR lanes; every lane of the row gets the same value
template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

struct DecodeArgs {
  const void* q;        // [B, Hq, D]
  const void* k;        // [B, S, Hkv, D]
  const void* v;        // [B, S, Hkv, D]
  const int* lengths;   // [B]
  void* out;            // [B, Hq, D]
  float* ws;            // [B, Hkv, splits] partials of G (D + 2): m [G], l [G], acc [G, D]
  int* counters;        // [B, Hkv], 0 between launches
  int s, hq, hkv, d, splits, chunk, vec;
  float scale2;         // scale log2 e
};

// LPR: lanes a row (16 B each), a power of two with LPR * 16 B >= the row;
// GP: the group's query heads G padded to a compiled count (1, 2, 4, 5 or
// 8), so the loops over them unroll fully; heads G .. GP - 1 run on zero q
// and are not written
template <typename T, int LPR, int GP>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int E = 16 / sizeof(T);           // elements a lane loads
  constexpr int RPW = 32 / LPR;               // rows a warp reads a load
  constexpr int STEP = kWarps * RPW * kUnroll;  // positions a block takes a step
  __shared__ __align__(16) float sm_q[GP][kMaxD];  // scale2 q, zeros past D and G
  __shared__ float sm_m[kWarps][GP], sm_l[kWarps][GP];
  __shared__ float sm_acc[kWarps][GP][kMaxD];
  __shared__ float sm_w[kMaxSplits][GP], sm_lw[kMaxSplits][GP], sm_lt[GP];
  __shared__ int last;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.hq / a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = lane / LPR, e0 = (lane % LPR) * E;
  const int len = min(max(a.lengths[b], 0), a.s);
  const int p_begin = split * a.chunk, p_end = min(p_begin + a.chunk, len);
  const int rec_len = G * (a.d + 2);
  float* rec = a.ws + (((size_t)b * a.hkv + hk) * a.splits + split) * rec_len;

  if (p_begin < p_end) {
    // this lane's rows of the warp's first step, loaded before q is staged;
    // a step's rows are p0 + u RPW + rw, the next step's load after this
    // step's sums
    const size_t stride = (size_t)a.hkv * a.d;  // between positions
    const T* kb = static_cast<const T*>(a.k) + ((size_t)b * a.s * a.hkv + hk) * a.d;
    const T* vb = static_cast<const T*>(a.v) + ((size_t)b * a.s * a.hkv + hk) * a.d;
    const bool vec = a.vec != 0;
    const int p_first = p_begin + warp * RPW * kUnroll;
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p_first + u * RPW + rw;
      kr[u] = p < p_end ? load16(kb + p * stride, e0, a.d, vec) : make_uint4(0, 0, 0, 0);
      vr[u] = p < p_end ? load16(vb + p * stride, e0, a.d, vec) : make_uint4(0, 0, 0, 0);
    }
    const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.hq + hk * G) * a.d;
    for (int o = threadIdx.x; o < GP * kMaxD; o += kThreads) {
      const int g = o / kMaxD, dd = o % kMaxD;
      sm_q[g][dd] = g < G && dd < a.d ? __fmul_rn(to_f32(q[g * a.d + dd]), a.scale2) : 0.0f;
    }
    __syncthreads();

    float m[GP], l[GP], acc[GP][E];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      m[g] = kNeg;
      l[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
    }

    // a warp-uniform loop: the shuffles need every lane
    for (int p0 = p_first; p0 < p_end; p0 += STEP) {
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ok[u] = p0 + u * RPW + rw < p_end;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&sm_q[g][e0 + e]);
          qv[e] = x.x;
          qv[e + 1] = x.y;
          qv[e + 2] = x.z;
          qv[e + 3] = x.w;
        }
        float s[kUnroll];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) part = __fmaf_rn(qv[e], elem<T>(kr[u], e), part);
          s[u] = row_sum<LPR>(part);
          if (ok[u]) mx = fmaxf(mx, s[u]);
        }
        const float alpha = exp2f(__fsub_rn(m[g], mx));
        float ps = 0.0f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = ok[u] ? exp2f(__fsub_rn(s[u], mx)) : 0.0f;
          ps = __fadd_rn(ps, s[u]);
        }
        l[g] = __fmaf_rn(l[g], alpha, ps);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float x = __fmul_rn(acc[g][e], alpha);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) x = __fmaf_rn(s[u], elem<T>(vr[u], e), x);
          acc[g][e] = x;
        }
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + STEP + u * RPW + rw;
        kr[u] = p < p_end ? load16(kb + p * stride, e0, a.d, vec) : make_uint4(0, 0, 0, 0);
        vr[u] = p < p_end ? load16(vb + p * stride, e0, a.d, vec) : make_uint4(0, 0, 0, 0);
      }
    }

    // merge the warp's rows (lanes LPR, 2 LPR, ... apart), then the warps
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(kFull, m[g], o), lo = __shfl_xor_sync(kFull, l[g], o);
        const float mx = fmaxf(m[g], mo);
        const float c = l[g] > 0.0f ? exp2f(__fsub_rn(m[g], mx)) : 0.0f;
        const float co = lo > 0.0f ? exp2f(__fsub_rn(mo, mx)) : 0.0f;
        l[g] = __fadd_rn(__fmul_rn(l[g], c), __fmul_rn(lo, co));
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(kFull, acc[g][e], o);
          acc[g][e] = __fadd_rn(__fmul_rn(acc[g][e], c), __fmul_rn(ao, co));
        }
        m[g] = mx;
      }
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
      if (rw == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e0 + e < a.d) sm_acc[warp][g][e0 + e] = acc[g][e];
        }
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < G * a.d; o += kThreads) {
      const int g = o / a.d, dd = o % a.d;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_l[w][g] > 0.0f) mx = fmaxf(mx, sm_m[w][g]);
      }
      float lt = 0.0f, at = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = sm_l[w][g] > 0.0f ? exp2f(__fsub_rn(sm_m[w][g], mx)) : 0.0f;
        lt = __fmaf_rn(sm_l[w][g], c, lt);
        at = __fmaf_rn(sm_acc[w][g][dd], c, at);
      }
      rec[2 * G + o] = at;
      if (dd == 0) {
        rec[g] = mx;
        rec[G + g] = lt;
      }
    }
  } else {
    // no valid position in this split: an empty partial (l = 0, acc = 0),
    // no loads
    for (int o = threadIdx.x; o < rec_len; o += kThreads) rec[o] = o < G ? kNeg : 0.0f;
  }

  // the last block of this (batch, KV head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&a.counters[b * a.hkv + hk], 1) == a.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every split's m and l into shared memory, then each query head's
  // common max, its splits' weights 2^(m - max) (0 where l = 0) and the
  // normaliser, in split order; then each output sums its splits' acc
  const float* recs = a.ws + ((size_t)b * a.hkv + hk) * a.splits * rec_len;
  for (int i = threadIdx.x; i < a.splits * G; i += kThreads) {
    const int sp = i / G, g = i % G;
    sm_w[sp][g] = __ldcg(recs + (size_t)sp * rec_len + g);
    sm_lw[sp][g] = __ldcg(recs + (size_t)sp * rec_len + G + g);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNeg;
    for (int sp = 0; sp < a.splits; ++sp) {
      if (sm_lw[sp][g] > 0.0f) mx = fmaxf(mx, sm_w[sp][g]);
    }
    float lt = 0.0f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float c = sm_lw[sp][g] > 0.0f ? exp2f(__fsub_rn(sm_w[sp][g], mx)) : 0.0f;
      sm_w[sp][g] = c;
      lt = __fmaf_rn(sm_lw[sp][g], c, lt);
    }
    sm_lt[g] = lt;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.hq + hk * G) * a.d;
  for (int o = threadIdx.x; o < G * a.d; o += kThreads) {
    const int g = o / a.d;
    float at = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < a.splits; ++sp) {
      at = __fmaf_rn(__ldcg(recs + (size_t)sp * rec_len + 2 * G + o), sm_w[sp][g], at);
    }
    const float lt = sm_lt[g];
    out[o] = from_f32<T>(lt > 0.0f ? __fdiv_rn(at, lt) : 0.0f);
  }
  if (threadIdx.x == 0) a.counters[b * a.hkv + hk] = 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the SM count of the current device, asked once a device
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) {
    n = 132;
  }
  if (dev < 64) counts[dev] = n;
  return n;
}

// lanes a row: 8, 16 or 32 (bf16 rows of up to 64, 128; float32 rows of up
// to 32, 64, 128)
int lanes_per_row(int d, int dtype) {
  const int need = (d + (dtype == 0 ? 3 : 7)) / (dtype == 0 ? 4 : 8);
  return need <= 8 ? 8 : need <= 16 ? 16 : 32;
}

typedef void (*Kernel)(DecodeArgs);

// the kernel for G query heads a KV head (its compiled count padded up)
template <typename T, int LPR>
Kernel kernel_g(int g) {
  if (g <= 1) return decode_kernel<T, LPR, 1>;
  if (g <= 2) return decode_kernel<T, LPR, 2>;
  if (g <= 4) return decode_kernel<T, LPR, 4>;
  if (g == 5) return decode_kernel<T, LPR, 5>;
  return decode_kernel<T, LPR, kMaxG>;
}

Kernel kernel_for(int dtype, int d, int g) {
  const int lpr = lanes_per_row(d, dtype);
  if (dtype == 1) return lpr == 8 ? kernel_g<__nv_bfloat16, 8>(g) : kernel_g<__nv_bfloat16, 16>(g);
  return lpr == 8 ? kernel_g<float, 8>(g) : lpr == 16 ? kernel_g<float, 16>(g) : kernel_g<float, 32>(g);
}

// splits and positions a split (a multiple of the block's step): as many
// splits as fill the card's resident blocks (the kernel's blocks an SM,
// from the occupancy calculator, times the SM count) over the B Hkv
// (batch, KV head) pairs in one wave, at most kMaxSplits
void plan(int batch, int s, int hq, int hkv, int d, int dtype, int* splits, int* chunk) {
  const int lpr = lanes_per_row(d, dtype), step = kWarps * (32 / lpr) * kUnroll;
  // blocks an SM, asked once a kernel
  static int occupancy[2][3][kMaxG + 1];
  int& per_sm = occupancy[dtype][lpr == 8 ? 0 : lpr == 16 ? 1 : 2][hq / hkv];
  if (per_sm < 1 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, kernel_for(dtype, d, hq / hkv), kThreads, 0) != cudaSuccess ||
                     per_sm < 1)) {
    per_sm = 1;
  }
  const int want = per_sm * sm_count() / (batch * hkv);
  const int n = std::max(1, std::min({want, (s + step - 1) / step, kMaxSplits}));
  *chunk = ((s + n - 1) / n + step - 1) / step * step;
  *splits = (s + *chunk - 1) / *chunk;
}

bool shape_ok(int batch, int s, int hq, int hkv, int d, int dtype) {
  return batch >= 1 && batch <= 65535 && s >= 1 && hkv >= 1 && hkv <= 65535 && hq % hkv == 0 &&
         hq / hkv <= kMaxG && d >= 1 && d <= kMaxD && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// Largest query heads per KV head and head dim the kernel takes.
int decode_attention_limits(int* max_group, int* max_d) {
  *max_group = kMaxG;
  *max_d = kMaxD;
  return 0;
}

// The splits of the cache a launch at these shapes runs, each a block per
// (batch, KV head); the workspace holds batch * hkv * splits * (hq / hkv) *
// (d + 2) floats. Returns a cudaError_t.
int decode_attention_splits(int batch, int s, int hq, int hkv, int d, int dtype, int* splits) {
  if (!shape_ok(batch, s, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  int chunk = 0;
  plan(batch, s, hq, hkv, d, dtype, splits, &chunk);
  return 0;
}

// dtype: 0 float32, 1 bfloat16. workspace: float32, as decode_attention_splits
// sizes it for `splits`, its value; counters: int32 [batch * hkv], zero
// before the launch and zero again after it. Returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, float* workspace, int* counters, int splits, int batch,
                            int s, int hq, int hkv, int d, float scale, int dtype, void* stream) {
  if (!shape_ok(batch, s, hq, hkv, d, dtype)) return (int)cudaErrorInvalidValue;
  int want = 0, chunk = 0;
  plan(batch, s, hq, hkv, d, dtype, &want, &chunk);
  if (splits != want) return (int)cudaErrorInvalidValue;
  const int e = dtype == 0 ? 4 : 8;
  const int vec = d % e == 0 && aligned16(k) && aligned16(v);
  DecodeArgs a{q, k, v, lengths, out, workspace, counters, s, hq, hkv, d, splits, chunk, vec,
               scale * kLog2e};
  kernel_for(dtype, d, hq / hkv)<<<dim3(splits, hkv, batch), kThreads, 0,
                                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
