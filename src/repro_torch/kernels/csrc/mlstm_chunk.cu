// Chunkwise mLSTM / SSD (matrix-memory linear cell), for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/mlstm_chunk.py: mlstm_chunk_pallas / _mlstm_kernel (lines
// 45-300). For q, k [B, S, H, Dk], v [B, S, H, Dv] and float32 gates
// i, f [B, S, H] it runs the recurrence chunk by chunk: inside a chunk of c
// positions every output is computed in parallel from the intra-chunk
// scores (q_j . k_s) exp(F_j - F_s + i_s - m_j), s <= j, and from the state
// carried in from the earlier chunks (C [Dk, Dv], n [Dk], stabiliser m);
// then the state moves to the chunk's end. normalize = 1 is xLSTM's mLSTM
// (log-sigmoid forget gate, stabiliser m, normaliser max(|.|, e^-m) + eps);
// normalize = 0 is mamba-2's SSD (f is the raw log-decay, m stays 0, no
// normaliser). q is scaled by `scale` in float32. Positions past S pad the
// last chunk with q = k = v = 0, i = -1e30 and f = f_pad, as the TPU
// wrapper pads them. Inputs are float32 or bf16 (the gates float32); every
// sum runs in float32 and out [B, S, H, Dv] is written in the input's type.
//
// What bounds it on this card. At the serving path's SSD shapes (B 8, S
// 2,048, H 25, Dk 16, Dv 128) the pass moves ~240 MB (q, k, v, gates in,
// out) for ~11 GFLOP of products: bytes, ~0.07 ms at 3.35 TB/s. At
// xLSTM's mLSTM shapes (B 8, S 2,048, H 4, Dk = Dv = 512) it does ~80
// GFLOP of products for ~134 MB: operations, ~0.08 ms on the bf16 tensor
// cores, ~1.2 ms in float32 on the CUDA cores.
//
// Three kernels. Up to Dk 64: bf16 SSD (normalize = 0, chunks a multiple
// of 16) runs mlstm_ssd_mma_kernel on the tensor cores (below); float32
// inputs, the mLSTM (normalize = 1) and other chunk sizes run
// mlstm_chunk_kernel, the first, simple CUDA-core design: float32 fused
// multiply-adds, one (batch, head, 64-wide slice of Dv) per block walking
// its chunks in order, as the TPU grid walks them; the slices of one head
// recompute the [c, c] scores (cheap at Dk 16) so that the state C [Dk, 64]
// fits in shared memory beside the chunk's q, k, v and scores. Per chunk:
// the gates' inclusive cumsum (one thread, in order), the scores and row
// quantities with two threads per row, the [c, 64] output tile with a 4 x 8
// register tile per thread (the scores times v plus the inter-chunk term q
// C), then the state update. Dk up to 64 and chunks up to 128 positions in
// both. Past Dk 64 (xLSTM's heads are 512 wide) every call runs
// mlstm_chunk_tiled_kernel, which streams q and k through shared memory in
// Dk tiles of 32 (below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxC = 128;    // positions per chunk
constexpr int kMaxDvT = 64;   // Dv columns per block
constexpr int kMaxDk = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

struct MlstmArgs {
  const void* q;    // [B, S, H, Dk]
  const void* k;    // [B, S, H, Dk]
  const void* v;    // [B, S, H, Dv]
  const float* ig;  // [B, S, H]
  const float* fg;  // [B, S, H]
  void* out;        // [B, S, H, Dv]
  int s, h, dk, dv, chunk, normalize;
  float scale, eps, f_pad;
};

template <int DK>
constexpr int smem_floats() {
  return kMaxC * (DK + 1)          // q (row stride DK + 1)
         + kMaxC * DK              // k, then k scaled to the chunk's end
         + kMaxC * kMaxDvT         // v slice
         + kMaxC * (kMaxC + 1)     // intra-chunk scores
         + DK * kMaxDvT            // state C slice
         + DK                      // state n
         + 6 * kMaxC               // F, i, m_row, inter, norm, end weights
         + 4;                      // f_end, m_new, decay
}

// DK: Dk padded to 16 (SSD state) or 64 (zeros past dk).
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) mlstm_chunk_kernel(MlstmArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int QS = DK + 1;
  constexpr int SS = kMaxC + 1;
  float* qs = sm;
  float* ks = qs + kMaxC * QS;
  float* vs = ks + kMaxC * DK;
  float* ss = vs + kMaxC * kMaxDvT;
  float* cs = ss + kMaxC * SS;
  float* ns = cs + DK * kMaxDvT;
  float* fs = ns + DK;
  float* lis = fs + kMaxC;
  float* mrow = lis + kMaxC;
  float* inter = mrow + kMaxC;
  float* nrm = inter + kMaxC;
  float* ew = nrm + kMaxC;
  float* sc = ew + kMaxC;  // [0] f_end, [1] m_new, [2] decay

  const int t = threadIdx.x;
  const int dv0 = blockIdx.x * kMaxDvT, h = blockIdx.y, b = blockIdx.z;
  const int dvt = min(kMaxDvT, a.dv - dv0);
  const int C = a.chunk;
  const bool norm = a.normalize != 0;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  for (int i = t; i < DK * kMaxDvT; i += kThreads) cs[i] = 0.0f;
  for (int i = t; i < DK; i += kThreads) ns[i] = 0.0f;
  float m_prev = norm ? kNeg : 0.0f;

  const int n_chunks = (a.s + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;
    // ---- stage the chunk ----
    for (int i = t; i < C * DK; i += kThreads) {
      const int j = i / DK, d = i % DK, pos = c0 + j;
      const bool ok = pos < a.s && d < a.dk;
      const size_t off = (((size_t)b * a.s + pos) * a.h + h) * a.dk + d;
      qs[j * QS + d] = ok ? __fmul_rn(to_f32(q[off]), a.scale) : 0.0f;
      ks[j * DK + d] = ok ? to_f32(k[off]) : 0.0f;
    }
    for (int i = t; i < C * kMaxDvT; i += kThreads) {
      const int j = i / kMaxDvT, c = i % kMaxDvT, pos = c0 + j;
      const bool ok = pos < a.s && c < dvt;
      vs[i] = ok ? to_f32(v[(((size_t)b * a.s + pos) * a.h + h) * a.dv + dv0 + c]) : 0.0f;
    }
    for (int j = t; j < C; j += kThreads) {
      const int pos = c0 + j;
      const size_t off = ((size_t)b * a.s + pos) * a.h + h;
      const float fg = pos < a.s ? a.fg[off] : a.f_pad;
      lis[j] = pos < a.s ? a.ig[off] : kNeg;
      fs[j] = norm ? log_sigmoid(fg) : fg;
    }
    __syncthreads();
    if (t == 0) {  // inclusive cumulative log forget gate, in order
      float acc = 0.0f;
      for (int j = 0; j < C; ++j) {
        acc = __fadd_rn(acc, fs[j]);
        fs[j] = acc;
      }
      sc[0] = acc;
    }
    __syncthreads();

    // ---- scores: two threads per row j, each half of the columns ----
    {
      const int j = t >> 1, hf = t & 1;
      const bool row_ok = j < C;
      const int half = (C + 1) >> 1;
      const int sb = hf * half, se = min(C, sb + half);
      float qr[DK];
#pragma unroll
      for (int d = 0; d < DK; ++d) qr[d] = row_ok ? qs[j * QS + d] : 0.0f;
      const float fj = row_ok ? fs[j] : 0.0f;
      float mx = kNeg;
      if (norm && row_ok) {
        for (int s = sb; s < min(se, j + 1); ++s) {
          mx = fmaxf(mx, __fadd_rn(__fsub_rn(fj, fs[s]), lis[s]));
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float mr = norm ? fmaxf(mx, __fadd_rn(fj, m_prev)) : 0.0f;
      float rs = 0.0f;
      if (row_ok) {
        for (int s = sb; s < se; ++s) {
          float val = 0.0f;
          if (s <= j) {
            float dot = 0.0f;
#pragma unroll
            for (int d = 0; d < DK; d += 4) {
              const float4 kk = *reinterpret_cast<const float4*>(&ks[s * DK + d]);
              dot = __fmaf_rn(qr[d], kk.x, dot);
              dot = __fmaf_rn(qr[d + 1], kk.y, dot);
              dot = __fmaf_rn(qr[d + 2], kk.z, dot);
              dot = __fmaf_rn(qr[d + 3], kk.w, dot);
            }
            const float dm = __fadd_rn(__fsub_rn(fj, fs[s]), lis[s]);
            val = __fmul_rn(dot, expf(__fsub_rn(dm, mr)));
          }
          ss[j * SS + s] = val;
          rs = __fadd_rn(rs, val);
        }
      }
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
      if (row_ok && hf == 0) {
        const float it = expf(__fsub_rn(__fadd_rn(fj, m_prev), mr));
        mrow[j] = mr;
        inter[j] = it;
        if (norm) {
          float qn = 0.0f;
#pragma unroll
          for (int d = 0; d < DK; ++d) qn = __fmaf_rn(qr[d], ns[d], qn);
          const float den = __fadd_rn(rs, __fmul_rn(it, qn));
          nrm[j] = __fadd_rn(fmaxf(fabsf(den), expf(-mr)), a.eps);
        }
      }
    }
    __syncthreads();

    // ---- output tile: scores @ v + inter * (q @ C), rows ty + 32 r,
    //      columns tx + 8 c ----
    {
      const int tx = t & 7, ty = t >> 3;
      float o[4][8], qc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) o[r][c] = qc[r][c] = 0.0f;
      }
      const int s_end = min(C, ty + 96 + 1);
      for (int s = 0; s < s_end; ++s) {
        float sv[4], vv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = ty + 32 * r < C ? ss[(ty + 32 * r) * SS + s] : 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) vv[c] = vs[s * kMaxDvT + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) o[r][c] = __fmaf_rn(sv[r], vv[c], o[r][c]);
        }
      }
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        float qv[4], cv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = ty + 32 * r < C ? qs[(ty + 32 * r) * QS + d] : 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) cv[c] = cs[d * kMaxDvT + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) qc[r][c] = __fmaf_rn(qv[r], cv[c], qc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 32 * r, pos = c0 + j;
        if (j >= C || pos >= a.s) continue;
        const float it = inter[j];
        const float nj = norm ? nrm[j] : 1.0f;
        const size_t base = (((size_t)b * a.s + pos) * a.h + h) * a.dv + dv0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = tx + 8 * c;
          if (col >= dvt) continue;
          float val = __fadd_rn(o[r][c], __fmul_rn(it, qc[r][c]));
          if (norm) val = __fdiv_rn(val, nj);
          out[base + col] = from_f32<T>(val);
        }
      }
    }
    __syncthreads();  // C, q, k, v read by every thread before the update

    // ---- state update to the chunk's end ----
    const float f_end = sc[0];
    if (t < 32) {
      float wmax = kNeg;
      for (int s = t; s < C; s += 32) {
        wmax = fmaxf(wmax, __fadd_rn(__fsub_rn(f_end, fs[s]), lis[s]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
      if (t == 0) {
        const float m_new = norm ? fmaxf(__fadd_rn(m_prev, f_end), wmax) : 0.0f;
        sc[1] = m_new;
        sc[2] = expf(__fsub_rn(__fadd_rn(m_prev, f_end), m_new));
      }
    }
    __syncthreads();
    const float m_new = sc[1], decay = sc[2];
    for (int s = t; s < C; s += kThreads) {
      ew[s] = expf(__fsub_rn(__fadd_rn(__fsub_rn(f_end, fs[s]), lis[s]), m_new));
    }
    __syncthreads();
    for (int i = t; i < C * DK; i += kThreads) ks[i] = __fmul_rn(ks[i], ew[i / DK]);
    __syncthreads();
    for (int e = t; e < DK * dvt; e += kThreads) {
      const int d = e / dvt, c = e % dvt;
      float acc = 0.0f;
      for (int s = 0; s < C; ++s) acc = __fmaf_rn(ks[s * DK + d], vs[s * kMaxDvT + c], acc);
      cs[d * kMaxDvT + c] = __fadd_rn(__fmul_rn(decay, cs[d * kMaxDvT + c]), acc);
    }
    for (int d = t; d < DK; d += kThreads) {
      float acc = 0.0f;
      for (int s = 0; s < C; ++s) acc = __fadd_rn(acc, ks[s * DK + d]);
      ns[d] = __fadd_rn(__fmul_rn(decay, ns[d]), acc);
    }
    m_prev = m_new;
    __syncthreads();
  }
}

template <typename T, int DK>
int launch(const MlstmArgs& a, int batch, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<DK>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_chunk_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.dv + kMaxDvT - 1) / kMaxDvT, a.h, batch);
  mlstm_chunk_kernel<T, DK><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dk(const MlstmArgs& a, int batch, cudaStream_t stream) {
  if (a.dk <= 16) return launch<T, 16>(a, batch, stream);
  return launch<T, kMaxDk>(a, batch, stream);
}

// ===========================================================================
// Past Dk 64: mlstm_chunk_tiled_kernel (both flags, float32 and bf16)
//
// xLSTM's mLSTM heads are Dk = Dv = 512 wide. mlstm_chunk_kernel keeps the
// chunk's q and k whole in shared memory beside the scores and a 64-wide
// slice of the state; at Dk 512 that is over 500 KB of the 227 KB a block
// may have. This kernel keeps the state slice C [Dk, 32] (64 KB at Dk 512)
// and the scores [c, c] in shared memory and streams q and k through it in
// Dk tiles of 32 positions' columns. One block of 256 threads owns one
// (batch, head, 32-wide slice of Dv) and walks its chunks in order. Per
// chunk:
//  - the gates (inclusive cumsum by one thread, in order), each row's
//    stabiliser m_j (one thread a row) and the inter-chunk weight;
//  - over the Dk tiles, thread (ty, tx) accumulates in registers the
//    scores q_j . k_s of rows ty + 16 r and columns tx + 16 c (8 x 8), the
//    inter-chunk term q_j C of rows ty + 16 r and its two state columns
//    tx, tx + 16 (8 x 2), and q_j . n (8): every Dv slice of a head
//    recomputes the scores and q . n, which do not depend on Dv;
//  - the scores masked (s <= j) and weighted by exp(F_j - F_s + i_s - m_j)
//    go to shared memory; one thread a row sums its row, in order, for the
//    normaliser;
//  - the [c, 32] output tile: the scores times v plus the inter-chunk term
//    (still in registers), over the normaliser;
//  - the state to the chunk's end: k scaled by exp(f_end - F_s + i_s -
//    m_new) is streamed again tile by tile, C = decay C + kw^T v and n =
//    decay n + sum_s kw.
// Every product is a float32 fused multiply-add on the CUDA cores, as in
// mlstm_chunk_kernel, whose arithmetic (and rounding, op for op) this
// kernel repeats with Dk split into tiles. Dk up to 512 (the state's
// shared memory grows with it: ~187 KB a block at 512, one block an SM),
// chunks up to 128 positions. The tensor-core form is later work.
// ===========================================================================
constexpr int kTlW = 32;             // Dv columns a block
constexpr int kTlD = 32;             // Dk columns of a staged q or k tile
constexpr int kTlStride = kTlD + 1;  // row stride of a staged tile
constexpr int kTlSS = kMaxC + 1;     // row stride of the scores
constexpr int kMaxDkTiled = 512;

// floats of dynamic shared memory at Dk padded to dkp, a multiple of kTlD
__host__ __device__ constexpr int tiled_smem_floats(int dkp) {
  return kMaxC * kTlSS             // scores
         + 2 * kMaxC * kTlStride   // q tile; k (then kw) tile
         + kMaxC * kTlW            // v slice
         + 7 * kMaxC               // F, i, m_row, inter, norm, end weights, q . n
         + 4                       // f_end, m_new, decay
         + dkp                     // state n
         + dkp * kTlW;             // state C slice
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mlstm_chunk_tiled_kernel(MlstmArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int dkp = (a.dk + kTlD - 1) / kTlD * kTlD;
  float* ss = sm;
  float* qt = ss + kMaxC * kTlSS;
  float* kt = qt + kMaxC * kTlStride;
  float* vs = kt + kMaxC * kTlStride;
  float* fs = vs + kMaxC * kTlW;
  float* lis = fs + kMaxC;
  float* mrow = lis + kMaxC;
  float* inter = mrow + kMaxC;
  float* nrm = inter + kMaxC;
  float* ew = nrm + kMaxC;
  float* qn = ew + kMaxC;
  float* sc = qn + kMaxC;  // [0] f_end, [1] m_new, [2] decay
  float* ns = sc + 4;
  float* cs = ns + dkp;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int dv0 = blockIdx.x * kTlW, h = blockIdx.y, b = blockIdx.z;
  const int dvt = min(kTlW, a.dv - dv0);
  const int C = a.chunk;
  const bool norm = a.normalize != 0;
  const size_t row_qk = (size_t)a.h * a.dk, row_v = (size_t)a.h * a.dv;
  const size_t head = (size_t)b * a.s * a.h + h;  // (b, position 0, h)
  const T* qg = static_cast<const T*>(a.q) + head * a.dk;
  const T* kg = static_cast<const T*>(a.k) + head * a.dk;
  const T* vg = static_cast<const T*>(a.v) + head * a.dv + dv0;
  T* og = static_cast<T*>(a.out) + head * a.dv + dv0;
  const float* igp = a.ig + head;
  const float* fgp = a.fg + head;

  for (int i = t; i < dkp * kTlW; i += kThreads) cs[i] = 0.0f;
  for (int i = t; i < dkp; i += kThreads) ns[i] = 0.0f;
  float m_prev = norm ? kNeg : 0.0f;

  const int n_chunks = (a.s + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;
    // ---- the chunk's gates and v slice ----
    for (int j = t; j < C; j += kThreads) {
      const int pos = c0 + j;
      const float fg = pos < a.s ? fgp[(size_t)pos * a.h] : a.f_pad;
      lis[j] = pos < a.s ? igp[(size_t)pos * a.h] : kNeg;
      fs[j] = norm ? log_sigmoid(fg) : fg;
    }
    for (int i = t; i < C * kTlW; i += kThreads) {
      const int j = i / kTlW, c = i % kTlW, pos = c0 + j;
      vs[i] = pos < a.s && c < dvt ? to_f32(vg[(size_t)pos * row_v + c]) : 0.0f;
    }
    __syncthreads();
    if (t == 0) {  // inclusive cumulative log forget gate, in order
      float acc = 0.0f;
      for (int j = 0; j < C; ++j) {
        acc = __fadd_rn(acc, fs[j]);
        fs[j] = acc;
      }
      sc[0] = acc;
    }
    __syncthreads();
    // ---- each row's stabiliser and inter-chunk weight (read after the
    //      tile loop's barriers) ----
    for (int j = t; j < C; j += kThreads) {
      const float fj = fs[j];
      float mr = 0.0f;
      if (norm) {
        float mx = kNeg;
        for (int s = 0; s <= j; ++s) mx = fmaxf(mx, __fadd_rn(__fsub_rn(fj, fs[s]), lis[s]));
        mr = fmaxf(mx, __fadd_rn(fj, m_prev));
      }
      mrow[j] = mr;
      inter[j] = expf(__fsub_rn(__fadd_rn(fj, m_prev), mr));
    }

    // ---- q k^T, q C and q . n, a Dk tile at a time ----
    float acc[8][8], qc[8][2], qnr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
      qc[r][0] = qc[r][1] = qnr[r] = 0.0f;
    }
    for (int d0 = 0; d0 < dkp; d0 += kTlD) {
      for (int i = t; i < C * kTlD; i += kThreads) {
        const int j = i / kTlD, d = i % kTlD, pos = c0 + j;
        const bool ok = pos < a.s && d0 + d < a.dk;
        const size_t off = (size_t)pos * row_qk + d0 + d;
        qt[j * kTlStride + d] = ok ? __fmul_rn(to_f32(qg[off]), a.scale) : 0.0f;
        kt[j * kTlStride + d] = ok ? to_f32(kg[off]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kTlD; ++d) {
        float qv[8], kv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) qv[r] = qt[(ty + 16 * r) * kTlStride + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) kv[c] = kt[(tx + 16 * c) * kTlStride + d];
        const float cv0 = cs[(d0 + d) * kTlW + tx], cv1 = cs[(d0 + d) * kTlW + tx + 16];
        const float nv = ns[d0 + d];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(qv[r], kv[c], acc[r][c]);
          qc[r][0] = __fmaf_rn(qv[r], cv0, qc[r][0]);
          qc[r][1] = __fmaf_rn(qv[r], cv1, qc[r][1]);
          qnr[r] = __fmaf_rn(qv[r], nv, qnr[r]);
        }
      }
      __syncthreads();  // the tile read by every thread before the next is staged
    }

    // ---- the scores, masked and weighted; the rows' q . n ----
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      if (j >= C) continue;
      const float fj = fs[j], mr = mrow[j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = tx + 16 * c;
        float val = 0.0f;
        if (s <= j) {
          const float dm = __fadd_rn(__fsub_rn(fj, fs[s]), lis[s]);
          val = __fmul_rn(acc[r][c], expf(__fsub_rn(dm, mr)));
        }
        ss[j * kTlSS + s] = val;
      }
      if (tx == 0) qn[j] = qnr[r];
    }
    __syncthreads();
    // ---- the normaliser: each row's sum in order, one thread a row ----
    if (norm) {
      for (int j = t; j < C; j += kThreads) {
        float rs = 0.0f;
        for (int s = 0; s <= j; ++s) rs = __fadd_rn(rs, ss[j * kTlSS + s]);
        const float den = __fadd_rn(rs, __fmul_rn(inter[j], qn[j]));
        nrm[j] = __fadd_rn(fmaxf(fabsf(den), expf(-mrow[j])), a.eps);
      }
    }
    __syncthreads();

    // ---- output tile: scores @ v + inter * (q C), over the normaliser;
    //      rows ty + 16 r, columns tx and tx + 16 ----
    {
      float o[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) o[r][0] = o[r][1] = 0.0f;
      const int s_end = min(C, ty + 16 * 7 + 1);
      for (int s = 0; s < s_end; ++s) {
        const float v0 = vs[s * kTlW + tx], v1 = vs[s * kTlW + tx + 16];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float sv = ss[(ty + 16 * r) * kTlSS + s];
          o[r][0] = __fmaf_rn(sv, v0, o[r][0]);
          o[r][1] = __fmaf_rn(sv, v1, o[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = ty + 16 * r, pos = c0 + j;
        if (j >= C || pos >= a.s) continue;
        const float it = inter[j];
        const float nj = norm ? nrm[j] : 1.0f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          if (col >= dvt) continue;
          float val = __fadd_rn(o[r][c], __fmul_rn(it, qc[r][c]));
          if (norm) val = __fdiv_rn(val, nj);
          og[(size_t)pos * row_v + col] = from_f32<T>(val);
        }
      }
    }

    // ---- the state to the chunk's end ----
    const float f_end = sc[0];
    if (t == 0) {
      float wmax = kNeg;
      for (int s = 0; s < C; ++s) wmax = fmaxf(wmax, __fadd_rn(__fsub_rn(f_end, fs[s]), lis[s]));
      const float m_new = norm ? fmaxf(__fadd_rn(m_prev, f_end), wmax) : 0.0f;
      sc[1] = m_new;
      sc[2] = expf(__fsub_rn(__fadd_rn(m_prev, f_end), m_new));
    }
    __syncthreads();
    const float m_new = sc[1], decay = sc[2];
    for (int s = t; s < C; s += kThreads) {
      ew[s] = expf(__fsub_rn(__fadd_rn(__fsub_rn(f_end, fs[s]), lis[s]), m_new));
    }
    __syncthreads();
    for (int d0 = 0; d0 < dkp; d0 += kTlD) {
      for (int i = t; i < C * kTlD; i += kThreads) {
        const int j = i / kTlD, d = i % kTlD, pos = c0 + j;
        const bool ok = pos < a.s && d0 + d < a.dk;
        kt[j * kTlStride + d] =
            ok ? __fmul_rn(to_f32(kg[(size_t)pos * row_qk + d0 + d]), ew[j]) : 0.0f;
      }
      __syncthreads();
      {  // C rows d0 + rd, d0 + rd + 16; columns cw, cw + 16
        const int cw = t & 15, rd = t >> 4;
        float u[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        for (int s = 0; s < C; ++s) {
          const float k0 = kt[s * kTlStride + rd], k1 = kt[s * kTlStride + rd + 16];
          const float v0 = vs[s * kTlW + cw], v1 = vs[s * kTlW + cw + 16];
          u[0][0] = __fmaf_rn(k0, v0, u[0][0]);
          u[0][1] = __fmaf_rn(k0, v1, u[0][1]);
          u[1][0] = __fmaf_rn(k1, v0, u[1][0]);
          u[1][1] = __fmaf_rn(k1, v1, u[1][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float* e = &cs[(d0 + rd + 16 * i) * kTlW + cw + 16 * c];
            *e = __fadd_rn(__fmul_rn(decay, *e), u[i][c]);
          }
        }
      }
      if (t < kTlD) {
        float acc_n = 0.0f;
        for (int s = 0; s < C; ++s) acc_n = __fadd_rn(acc_n, kt[s * kTlStride + t]);
        ns[d0 + t] = __fadd_rn(__fmul_rn(decay, ns[d0 + t]), acc_n);
      }
      __syncthreads();  // kw read by every thread before the next tile; the
                        // state complete before the next chunk
    }
    m_prev = m_new;
  }
}

size_t tiled_bytes(int dk) {
  return sizeof(float) * tiled_smem_floats((dk + kTlD - 1) / kTlD * kTlD);
}

template <typename T>
int tiled_prepare() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_tiled_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)tiled_bytes(kMaxDkTiled));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  return 0;
}

template <typename T>
int launch_tiled(const MlstmArgs& a, int batch, cudaStream_t stream) {
  int err = tiled_prepare<T>();
  if (err) return err;
  const dim3 grid((a.dv + kTlW - 1) / kTlW, a.h, batch);
  mlstm_chunk_tiled_kernel<T><<<grid, kThreads, tiled_bytes(a.dk), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int tiled_occupancy(int dk, int* blocks_per_sm, int* smem_bytes) {
  int err = tiled_prepare<T>();
  if (err) return err;
  *smem_bytes = (int)tiled_bytes(dk);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mlstm_chunk_tiled_kernel<T>, kThreads, tiled_bytes(dk));
}

// ===========================================================================
// bf16 SSD on the tensor cores: mlstm_ssd_mma_kernel
//
// One block of 8 warps owns one (batch, head, 128-wide slice of Dv) and
// walks its chunks in order (B H ceil(Dv / 128) blocks: 200 at hymba's
// shapes, all resident at once at 2 blocks an SM on 132 SMs, one wave).
// Chunk c + 1's q, k, v and gates are copied by cp.async into the second
// of two stages while chunk c computes. Per chunk:
//  - warp 0 scans the log decays (an inclusive scan of the warp, 4
//    positions a lane) and writes, by position, F log2 e, (i - F) log2 e,
//    exp(F), exp(f_end - F + i), and exp(f_end);
//  - every thread writes kw = k exp(f_end - F + i), rounded to bf16;
//  - warp (p, h) computes the output rows of the 16-row strips p and
//    7 - p (equal causal work) and the Dv columns 64 h .. 64 h + 63: first
//    scale exp(F_j) (q C) with C rounded to bf16 (mma, k = Dk), then for
//    every 16-key tile up to the diagonal S = scale q k^T (mma, k = Dk),
//    times exp2(F_j log2 e + (i_s - F_s) log2 e) where s <= j, rounded to
//    bf16 from the accumulator fragments and multiplied into V (mma, k =
//    16 keys), and writes the rows in bf16;
//  - warp w moves columns 16 w .. 16 w + 15 of the state: C = exp(f_end) C
//    + kw^T V (mma, A = kw^T by ldmatrix.trans, k = the chunk's keys), C in
//    float32 fragments in registers from chunk to chunk, then rounded to
//    bf16 into shared memory for the next chunk's q C.
// So the operands rounded to bf16 are the float32 values S_intra, kw and
// C, each only as an input to a product (repro_torch/kernels/ref.py
// mlstm_chunk_tc rounds at the same points); the carried state stays
// float32. Staged rows are XOR-swizzled by 16-B chunk, so the eight rows
// an ldmatrix reads hit eight different bank groups. Dk up to 64 (DKP 16
// or 64, zero-filled); chunks a multiple of 16 up to 128.
// ===========================================================================
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcDv = 128;          // Dv columns a block
constexpr int kTcVRow = 2 * kTcDv;  // bytes of a staged v (or C) row: 16 chunks of 16 B

typedef __nv_bfloat16 bf16;

template <int DKP>
struct TcSmem {
  static constexpr int kRow = 2 * DKP;                        // bytes of a q, k or kw row
  static constexpr int kQ = kMaxC * kRow;                     // a q (or k, kw) tile
  static constexpr int kV = kMaxC * kTcVRow;                  // a v tile
  static constexpr int kStage = 2 * kQ + kV + 2 * 4 * kMaxC;  // q, k, v, i, f
  static constexpr int kCs = DKP * kTcVRow;                   // C in bf16
  static constexpr int kTotal = 2 * kStage + kQ + kCs + 4 * 4 * kMaxC + 16;
};

// byte offset of 16-B chunk c of staged q / k / kw row r (DKP / 8 chunks a
// row), swizzled so that any 8 consecutive rows at one chunk hit 8 groups
template <int DKP>
__device__ __forceinline__ uint32_t qk_off(int r, int c) {
  constexpr int cpr = DKP / 8, sh = cpr == 2 ? 2 : cpr == 4 ? 1 : 0;
  return r * (2 * DKP) + ((c ^ ((r >> sh) & (cpr - 1))) << 4);
}

// byte offset of 16-B chunk c of staged v / C row r
__device__ __forceinline__ uint32_t v_off(int r, int c) { return r * kTcVRow + ((c ^ (r & 7)) << 4); }

struct SsdArgs {
  const bf16* q;    // [B, S, H, Dk]
  const bf16* k;    // [B, S, H, Dk]
  const bf16* v;    // [B, S, H, Dv]
  const float* ig;  // [B, S, H]
  const float* fg;  // [B, S, H]
  bf16* out;        // [B, S, H, Dv]
  int s, h, dk, dv, chunk;
  float scale, f_pad;
  int vec;          // Dk, Dv multiples of 8 and q, k, v, out 16-B aligned
};

// Stage chunk positions c0 .. c0 + chunk - 1 of q, k, v (the block's Dv
// slice) and the gates into one stage: rows past S and columns past Dk or
// the slice zero; the gates as they are (the scan pads them).
template <int DKP>
__device__ __forceinline__ void ssd_stage(const SsdArgs& a, char* stage, int b, int h,
                                          int dv0, int dvt, int c0) {
  using L = TcSmem<DKP>;
  const int t = threadIdx.x, C = a.chunk;
  const uint32_t qs = smem_addr(stage), ks = qs + L::kQ, vs = ks + L::kQ;
  float* gs = reinterpret_cast<float*>(stage + 2 * L::kQ + L::kV);
  const size_t row_qk = (size_t)a.h * a.dk, row_v = (size_t)a.h * a.dv;
  const bf16* qg = a.q + ((size_t)b * a.s * a.h + h) * a.dk;
  const bf16* kg = a.k + ((size_t)b * a.s * a.h + h) * a.dk;
  const bf16* vg = a.v + ((size_t)b * a.s * a.h + h) * a.dv + dv0;
  if (a.vec) {
    constexpr int cpr = DKP / 8;
    for (int i = t; i < C * cpr; i += kTcThreads) {
      const int r = i / cpr, c = i - r * cpr, pos = c0 + r;
      const bool ok = pos < a.s && 8 * c < a.dk;
      const size_t off = ok ? (size_t)pos * row_qk + 8 * c : 0;
      cp_async16(qs + qk_off<DKP>(r, c), qg + off, ok);
      cp_async16(ks + qk_off<DKP>(r, c), kg + off, ok);
    }
    for (int i = t; i < C * 16; i += kTcThreads) {
      const int r = i >> 4, c = i & 15, pos = c0 + r;
      const bool ok = pos < a.s && 8 * c < dvt;
      cp_async16(vs + v_off(r, c), vg + (ok ? (size_t)pos * row_v + 8 * c : 0), ok);
    }
  } else {
    for (int i = t; i < C * DKP; i += kTcThreads) {
      const int r = i / DKP, d = i - r * DKP, pos = c0 + r;
      const bool ok = pos < a.s && d < a.dk;
      const uint32_t o = qk_off<DKP>(r, d >> 3) + 2 * (d & 7);
      *reinterpret_cast<bf16*>(stage + o) = ok ? qg[(size_t)pos * row_qk + d] : __float2bfloat16(0.0f);
      *reinterpret_cast<bf16*>(stage + L::kQ + o) =
          ok ? kg[(size_t)pos * row_qk + d] : __float2bfloat16(0.0f);
    }
    for (int i = t; i < C * kTcDv; i += kTcThreads) {
      const int r = i / kTcDv, col = i - r * kTcDv, pos = c0 + r;
      const bool ok = pos < a.s && col < dvt;
      *reinterpret_cast<bf16*>(stage + 2 * L::kQ + v_off(r, col >> 3) + 2 * (col & 7)) =
          ok ? vg[(size_t)pos * row_v + col] : __float2bfloat16(0.0f);
    }
  }
  for (int i = t; i < 2 * C; i += kTcThreads) {
    const int r = i % C, pos = c0 + r;
    const bool ok = pos < a.s;
    const float* g = i < C ? a.ig : a.fg;
    cp_async4(smem_addr(gs + i), g + (ok ? ((size_t)b * a.s + pos) * a.h + h : 0), ok);
  }
}

template <int DKP>
__global__ void __launch_bounds__(kTcThreads, DKP == 16 ? 2 : 1)
    mlstm_ssd_mma_kernel(SsdArgs a) {
  using L = TcSmem<DKP>;
  constexpr int NK = DKP / 16;  // k-steps over the padded Dk; m-tiles of the state
  extern __shared__ __align__(128) char ssm[];
  char* kw = ssm + 2 * L::kStage;
  char* cs = kw + L::kQ;
  float* f2 = reinterpret_cast<float*>(cs + L::kCs);  // F log2 e
  float* a2 = f2 + kMaxC;                             // (i - F) log2 e
  float* inter = a2 + kMaxC;                          // exp(F)
  float* ew = inter + kMaxC;                          // exp(f_end - F + i)
  float* decay = ew + kMaxC;                          // [0] exp(f_end)

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gr = lane >> 2, tq = lane & 3;
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int dv0 = blockIdx.x * kTcDv, h = blockIdx.y, b = blockIdx.z;
  const int dvt = min(kTcDv, a.dv - dv0);
  const int C = a.chunk, n_str = C >> 4;
  const int n_chunks = (a.s + C - 1) / C;
  const uint32_t kw_a = smem_addr(kw), cs_a = smem_addr(cs);

  // the state: this warp's 16 columns, every Dk row, float32 fragments
  float cst[NK][2][4];
#pragma unroll
  for (int m = 0; m < NK; ++m) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cst[m][n][e] = 0.0f;
    }
  }
  for (int i = t; i < L::kCs / 16; i += kTcThreads) {
    reinterpret_cast<uint4*>(cs)[i] = make_uint4(0, 0, 0, 0);
  }

  ssd_stage<DKP>(a, ssm, b, h, dv0, dvt, 0);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;
    char* st = ssm + (ci & 1) * L::kStage;
    if (ci + 1 < n_chunks) ssd_stage<DKP>(a, ssm + ((ci + 1) & 1) * L::kStage, b, h, dv0, dvt, c0 + C);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ci staged
    const uint32_t qs = smem_addr(st), ks = qs + L::kQ, vs = ks + L::kQ;
    const float* gs = reinterpret_cast<const float*>(st + 2 * L::kQ + L::kV);

    // ---- the gates: inclusive scan of the log decays, 4 positions a lane ----
    if (warp == 0) {
      float lf[4], li[4], p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const bool ok = j < C && c0 + j < a.s;
        lf[e] = j < C ? (ok ? gs[C + j] : a.f_pad) : 0.0f;
        li[e] = ok ? gs[j] : kNeg;
        p[e] = e == 0 ? lf[0] : __fadd_rn(p[e - 1], lf[e]);
      }
      float x = p[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = __fadd_rn(x, y);
      }
      float excl = __shfl_up_sync(0xffffffffu, x, 1);
      if (lane == 0) excl = 0.0f;
      const float f_end = __shfl_sync(0xffffffffu, __fadd_rn(excl, p[3]), (C >> 2) - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j >= C) continue;
        const float F = __fadd_rn(excl, p[e]);
        f2[j] = __fmul_rn(F, kLog2e);
        a2[j] = __fmul_rn(__fsub_rn(li[e], F), kLog2e);
        inter[j] = expf(F);
        ew[j] = expf(__fadd_rn(__fsub_rn(f_end, F), li[e]));
      }
      if (lane == 0) decay[0] = expf(f_end);
    }
    __syncthreads();

    // ---- kw = k exp(f_end - F + i), rounded to bf16, in k's layout ----
    for (int i = t; i < C * (DKP / 8); i += kTcThreads) {
      const int r = i / (DKP / 8), c = i - r * (DKP / 8);
      const uint32_t o = qk_off<DKP>(r, c);
      const uint4 raw = *reinterpret_cast<const uint4*>(st + L::kQ + o);
      const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float w = ew[r];
      uint4 res;
      uint32_t* rp = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(kv[e]);
        rp[e] = pack_bf16(__fmul_rn(f.x, w), __fmul_rn(f.y, w));
      }
      *reinterpret_cast<uint4*>(kw + o) = res;
    }

    // ---- output rows: strips p and n_str - 1 - p, columns 64 hh .. ----
    {
      const int p = warp & 3, hh = warp >> 2;
      for (int si = 0; si < 2; ++si) {
        const int strip = si == 0 ? p : n_str - 1 - p;
        if (strip >= n_str || (si == 1 && strip <= p)) continue;
        const int m0 = 16 * strip;
        uint32_t qa[NK][4];
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          ldsm_x4(qs + qk_off<DKP>(m0 + l7 + 8 * l8, 2 * kk + l16), qa[kk]);
        }
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        }
        // the inter-chunk term: q C, C in bf16
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t bb[4];
            ldsm_x4_t(cs_a + v_off(16 * kk + l7 + 8 * l8, 2 * (4 * hh + jp) + l16), bb);
            mma16816(acc[2 * jp], qa[kk], bb[0], bb[1]);
            mma16816(acc[2 * jp + 1], qa[kk], bb[2], bb[3]);
          }
        }
        const int r_lo = m0 + gr, r_hi = r_lo + 8;
        const float s_lo = __fmul_rn(a.scale, inter[r_lo]), s_hi = __fmul_rn(a.scale, inter[r_hi]);
        const float f_lo = f2[r_lo], f_hi = f2[r_hi];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[n][0] = __fmul_rn(acc[n][0], s_lo);
          acc[n][1] = __fmul_rn(acc[n][1], s_lo);
          acc[n][2] = __fmul_rn(acc[n][2], s_hi);
          acc[n][3] = __fmul_rn(acc[n][3], s_hi);
        }
        // the intra-chunk term, 16 keys a step up to the diagonal
        for (int kt = 0; kt <= strip; ++kt) {
          float sc[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
          }
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            uint32_t bb[4];
            ldsm_x4(ks + qk_off<DKP>(16 * kt + l7 + 8 * l16, 2 * kk + l8), bb);
            mma16816(sc[0], qa[kk], bb[0], bb[1]);
            mma16816(sc[1], qa[kk], bb[2], bb[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s_ = 16 * kt + 8 * n + 2 * tq + (e & 1);
              const int j = e < 2 ? r_lo : r_hi;
              const float x = __fmul_rn(sc[n][e], a.scale);
              sc[n][e] = s_ <= j ? __fmul_rn(x, ex2(__fadd_rn(e < 2 ? f_lo : f_hi, a2[s_]))) : 0.0f;
            }
          }
          uint32_t sa[4];
          c_to_a(sc, 0, sa);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t bb[4];
            ldsm_x4_t(vs + v_off(16 * kt + l7 + 8 * l8, 2 * (4 * hh + jp) + l16), bb);
            mma16816(acc[2 * jp], sa, bb[0], bb[1]);
            mma16816(acc[2 * jp + 1], sa, bb[2], bb[3]);
          }
        }
        // the rows, in bf16
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 64 * hh + 8 * n + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pos = c0 + (half ? r_hi : r_lo);
            if (pos >= a.s || col >= dvt) continue;
            bf16* o = a.out + (((size_t)b * a.s + pos) * a.h + h) * a.dv + dv0 + col;
            if (a.vec) {
              *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
            } else {
              o[0] = __float2bfloat16(acc[n][2 * half]);
              if (col + 1 < dvt) o[1] = __float2bfloat16(acc[n][2 * half + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // kw written; every read of C (bf16) done

    // ---- the state to the chunk's end: C = exp(f_end) C + kw^T V ----
    {
      const float dc = decay[0];
#pragma unroll
      for (int m = 0; m < NK; ++m) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cst[m][n][e] = __fmul_rn(cst[m][n][e], dc);
        }
      }
      for (int kt = 0; kt < n_str; ++kt) {
        uint32_t bb[4];
        ldsm_x4_t(vs + v_off(16 * kt + l7 + 8 * l8, 2 * warp + l16), bb);
#pragma unroll
        for (int m = 0; m < NK; ++m) {
          uint32_t aa[4];
          ldsm_x4_t(kw_a + qk_off<DKP>(16 * kt + l7 + 8 * l16, 2 * m + l8), aa);
          mma16816(cst[m][0], aa, bb[0], bb[1]);
          mma16816(cst[m][1], aa, bb[2], bb[3]);
        }
      }
      // C in bf16 for the next chunk's q C: rows d, columns 16 warp ..
#pragma unroll
      for (int m = 0; m < NK; ++m) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * warp + 8 * n + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int d = 16 * m + gr + 8 * half;
            *reinterpret_cast<uint32_t*>(cs + v_off(d, col >> 3) + 2 * (col & 7)) =
                pack_bf16(cst[m][n][2 * half], cst[m][n][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();  // C complete; this stage free for chunk ci + 2
  }
  cp_async_wait<0>();
}

template <int DKP>
int ssd_prepare(size_t* bytes) {
  *bytes = TcSmem<DKP>::kTotal;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_ssd_mma_kernel<DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  return 0;
}

template <int DKP>
int launch_ssd(const SsdArgs& a, int batch, cudaStream_t stream) {
  size_t bytes;
  int err = ssd_prepare<DKP>(&bytes);
  if (err) return err;
  const dim3 grid((a.dv + kTcDv - 1) / kTcDv, a.h, batch);
  mlstm_ssd_mma_kernel<DKP><<<grid, kTcThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DKP>
int ssd_occupancy(int* blocks_per_sm, int* smem_bytes) {
  size_t bytes;
  int err = ssd_prepare<DKP>(&bytes);
  if (err) return err;
  *smem_bytes = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mlstm_ssd_mma_kernel<DKP>, kTcThreads, bytes);
}

}  // namespace

extern "C" {

// Largest Dk and chunk the kernels take.
int mlstm_chunk_limits(int* max_dk, int* max_chunk) {
  *max_dk = kMaxDkTiled;
  *max_chunk = kMaxC;
  return 0;
}

// Whether a call at this Dk runs the Dk-tiled kernel (every call past Dk 64).
int mlstm_chunk_uses_tiled(int dk) { return dk > kMaxDk; }

// Whether a call runs the tensor-core SSD kernel: bf16, normalize = 0, a
// chunk that is a multiple of 16 and Dk up to 64.
int mlstm_chunk_uses_mma(int dtype, int normalize, int chunk, int dk) {
  return dtype == 1 && normalize == 0 && chunk % 16 == 0 && !mlstm_chunk_uses_tiled(dk);
}

// The Dk-tiled kernel's resident blocks an SM and dynamic shared memory a
// block at this Dk (dtype: 0 float32, 1 bfloat16).
int mlstm_chunk_tiled_occupancy(int dk, int dtype, int* blocks_per_sm, int* smem_bytes) {
  if (dk <= kMaxDk || dk > kMaxDkTiled || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return dtype == 0 ? tiled_occupancy<float>(dk, blocks_per_sm, smem_bytes)
                    : tiled_occupancy<__nv_bfloat16>(dk, blocks_per_sm, smem_bytes);
}

// The tensor-core SSD kernel's resident blocks an SM and shared memory a
// block at this Dk.
int mlstm_chunk_mma_occupancy(int dk, int* blocks_per_sm, int* smem_bytes) {
  if (dk < 1 || dk > kMaxDk) return (int)cudaErrorInvalidValue;
  return dk <= 16 ? ssd_occupancy<16>(blocks_per_sm, smem_bytes)
                  : ssd_occupancy<kMaxDk>(blocks_per_sm, smem_bytes);
}

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t.
int mlstm_chunk_launch(const void* q, const void* k, const void* v, const float* ig,
                       const float* fg, void* out, int batch, int s, int h, int dk, int dv,
                       int chunk, int normalize, float scale, float eps, float f_pad,
                       int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || h < 1 || h > 65535 || dk < 1 ||
      dk > kMaxDkTiled || dv < 1 || chunk < 1 || chunk > kMaxC || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (mlstm_chunk_uses_tiled(dk)) {
    MlstmArgs a{q, k, v, ig, fg, out, s, h, dk, dv, chunk, normalize, scale, eps, f_pad};
    return dtype == 0 ? launch_tiled<float>(a, batch, st)
                      : launch_tiled<__nv_bfloat16>(a, batch, st);
  }
  if (mlstm_chunk_uses_mma(dtype, normalize, chunk, dk)) {
    const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
    SsdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), ig, fg, static_cast<bf16*>(out),
              s, h, dk, dv, chunk, scale, f_pad, aligned && dk % 8 == 0 && dv % 8 == 0};
    return dk <= 16 ? launch_ssd<16>(a, batch, st) : launch_ssd<kMaxDk>(a, batch, st);
  }
  MlstmArgs a{q, k, v, ig, fg, out, s, h, dk, dv, chunk, normalize, scale, eps, f_pad};
  return dtype == 0 ? launch_dk<float>(a, batch, st) : launch_dk<__nv_bfloat16>(a, batch, st);
}

}  // extern "C"
