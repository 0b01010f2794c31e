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
// Five kernels. Up to Dk 64: bf16 SSD (normalize = 0, chunks a multiple
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
// both. Past Dk 64 (xLSTM's heads are 512 wide) bf16 calls with chunks a
// multiple of 16 (both flags) run two tensor-core launches,
// mlstm_wide_state_kernel then mlstm_wide_out_kernel (below); float32 calls
// and other chunk sizes run mlstm_chunk_tiled_kernel, which streams q and k
// through shared memory in Dk tiles of 32 on the CUDA cores (below).

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
// chunks up to 128 positions. It runs float32 calls and bf16 calls whose
// chunk is not a multiple of 16; the other bf16 calls run the tensor-core
// pair mlstm_wide_state_kernel / mlstm_wide_out_kernel (at the end).
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

// ===========================================================================
// bf16 past Dk 64 on the tensor cores: mlstm_wide_state_kernel, then
// mlstm_wide_out_kernel (both flags; chunks a multiple of 16)
//
// At xLSTM's widths (Dk = Dv = 512, chunk 128) nine tenths of the cell's
// ~39 G multiply-adds are the two products with the state, q C and
// kw^T V ([c, Dk] x [Dk, Dv] a chunk each), which need the chunks in
// order; the scores q k^T, their row sums, q . n and the stabiliser do not
// depend on Dv. So the work is split in two launches, and each product
// runs once (bf16 operands, float32 sums, mma.sync m16n8k16):
//  1. mlstm_wide_state_kernel: one block of 16 warps a (batch, head,
//     64-wide slice of Dv) walks the chunks in order. Per chunk, warp 0
//     scans the gates (F, the rows' stabiliser m_j by a prefix max of i_s
//     - F_s, the inter-chunk weight exp(F_j + m - m_j), m_new, the decay
//     and the end weights exp(f_end - F_s + i_s - m_new)); slice 0 writes
//     each position's F, i - F and m_j (times log2 e) and the inter-chunk
//     weight for launch 2. The block holds the state transposed, C^T [64,
//     Dk], in float32 fragments in registers from chunk to chunk: warp (mt,
//     dq) its rows 16 mt .. 16 mt + 15 and quarter dq of Dk (64 registers a
//     thread at Dk 512), so its fragments, rounded to bf16, are the A
//     operand of (q C)^T = C^T q^T with no copy of C in shared memory. q,
//     then k, stream through a ring of three stages in blocks of 32
//     positions over all of Dk (cp.async, two blocks ahead). A q block:
//     each warp's share of C^T q^T over its quarter of Dk; the quarters are
//     added through shared memory and inter_j scale (q_j C) goes to a
//     float32 buffer z [B, S, H, Dv]. A k block: kw = k exp(w) is rounded to
//     bf16 in place, then C^T = decay C^T + V^T kw (the chunk's v slice
//     staged once). Under normalize, slice x also carries n for the Dk
//     tiles x, x + n_slices, ... (float32, in shared memory): its share of
//     q . n from each q block (16 threads a row), written apart for launch
//     2 to add in slice order, and n = decay n + sum_s kw (kw as rounded
//     for the product) after the chunk's k blocks.
//  2. mlstm_wide_out_kernel: one block a (batch, head, chunk), 2 a SM. Warp
//     (p, hh) accumulates the scores of row strips p and c/16 - 1 - p
//     (equal causal work) over the k-steps 2 hh, 2 hh + 1 of each Dk tile;
//     the hh = 1 half's sums are added to the hh = 0 half's through shared
//     memory; hh = 0 weights them by exp2(F_j + (i_s - F_s) - m_j) where
//     s <= j, sums each row in float32 (the normaliser max(|sum + inter
//     q . n|, e^-m_j) + eps) and writes S in bf16; then V streams in Dv
//     tiles of 64 and warp (p, hh) writes (S V + z) / normaliser for its
//     strips and 32 columns, in bf16.
// The scores and q . n are computed once a (batch, head, chunk) (q . n in
// disjoint Dk shares across the slices), the state products once a column
// of the state; what repeats per Dv slice is the gate scan (c positions)
// and the scaling of k by the end weights (c Dk multiplies). The operands rounded to bf16 are the float32 values
// S_intra, kw and C, only as inputs to a product (ref.py mlstm_chunk_tc
// with normalize models the same points; the row sums and q . n are taken
// in float32 from the unrounded S_intra and n). Dk up to 512 in tiles of 64
// (zero-filled), Dv any width (slices of 64, zero-filled), chunks a
// multiple of 16 up to 128. Launch 2 reads launch 1's z, the gates and
// q . n from one float32 scratch buffer the wrapper allocates
// (mlstm_chunk_scratch_floats).
// ===========================================================================
constexpr int kWd = 64;                        // Dk tile, Dv slice and tile width
constexpr int kWdRow = 2 * kWd;                // bytes of a staged 64-wide bf16 row
constexpr int kWdTile = kMaxC * kWdRow;        // a [128, 64] bf16 tile (16 KB)
constexpr int kWdMaxTiles = 9;                 // score tiles a warp pair (8 strips)

// byte offset of 16-B chunk c (0..7) of staged 64-wide row r
__device__ __forceinline__ uint32_t w_off(int r, int c) { return r * kWdRow + ((c ^ (r & 7)) << 4); }

struct WideArgs {
  const bf16* q;    // [B, S, H, Dk]
  const bf16* k;    // [B, S, H, Dk]
  const bf16* v;    // [B, S, H, Dv]
  const float* ig;  // [B, S, H]
  const float* fg;  // [B, S, H]
  bf16* out;        // [B, S, H, Dv]
  float* z;         // [B, S, H, Dv]: inter_j (q_j C), launch 1 to launch 2
  float* gates;     // [B, H, 4, Sp]: F log2 e, (i - F) log2 e, m_j log2 e, inter_j
  float* qn;        // [B, H, ceil(Dv / 64), Sp]: each Dv slice's share of q_j . n
  int s, h, dk, dv, chunk, normalize;
  float scale, eps, f_pad;
  int vec;          // Dk, Dv multiples of 8 and q, k, v, out 16-B aligned
};

// q and k columns 64 kt .. 64 kt + 63 of positions c0 .. c0 + chunk - 1
// into a stage (q tile, then k tile): rows past S and columns past Dk zero
__device__ __forceinline__ void wide_stage_qk(const WideArgs& a, char* st, int b, int h, int c0,
                                              int kt) {
  const int t = threadIdx.x, C = a.chunk, d0 = kt * kWd;
  const uint32_t qs = smem_addr(st), ks = qs + kWdTile;
  const size_t row = (size_t)a.h * a.dk;
  const bf16* qg = a.q + ((size_t)b * a.s * a.h + h) * a.dk;
  const bf16* kg = a.k + ((size_t)b * a.s * a.h + h) * a.dk;
  if (a.vec) {
    for (int i = t; i < C * 8; i += kTcThreads) {
      const int r = i >> 3, c = i & 7, pos = c0 + r, d = d0 + 8 * c;
      const bool ok = pos < a.s && d < a.dk;
      const size_t off = ok ? (size_t)pos * row + d : 0;
      cp_async16(qs + w_off(r, c), qg + off, ok);
      cp_async16(ks + w_off(r, c), kg + off, ok);
    }
  } else {
    for (int i = t; i < C * kWd; i += kTcThreads) {
      const int r = i >> 6, col = i & 63, pos = c0 + r, d = d0 + col;
      const bool ok = pos < a.s && d < a.dk;
      const uint32_t o = w_off(r, col >> 3) + 2 * (col & 7);
      const size_t off = (size_t)pos * row + d;
      *reinterpret_cast<bf16*>(st + o) = ok ? qg[off] : __float2bfloat16(0.0f);
      *reinterpret_cast<bf16*>(st + kWdTile + o) = ok ? kg[off] : __float2bfloat16(0.0f);
    }
  }
}

// v columns dv0 .. dv0 + 63 of positions c0 .. c0 + chunk - 1 into a tile
__device__ __forceinline__ void wide_stage_v(const WideArgs& a, char* vt, int b, int h, int c0,
                                             int dv0) {
  const int t = threadIdx.x, C = a.chunk;
  const uint32_t vs = smem_addr(vt);
  const size_t row = (size_t)a.h * a.dv;
  const bf16* vg = a.v + ((size_t)b * a.s * a.h + h) * a.dv;
  if (a.vec) {
    for (int i = t; i < C * 8; i += kTcThreads) {
      const int r = i >> 3, c = i & 7, pos = c0 + r, d = dv0 + 8 * c;
      const bool ok = pos < a.s && d < a.dv;
      cp_async16(vs + w_off(r, c), vg + (ok ? (size_t)pos * row + d : 0), ok);
    }
  } else {
    for (int i = t; i < C * kWd; i += kTcThreads) {
      const int r = i >> 6, col = i & 63, pos = c0 + r, d = dv0 + col;
      const bool ok = pos < a.s && d < a.dv;
      *reinterpret_cast<bf16*>(vt + w_off(r, col >> 3) + 2 * (col & 7)) =
          ok ? vg[(size_t)pos * row + d] : __float2bfloat16(0.0f);
    }
  }
}

// The state kernel's staged rows are padded by 16 B: the eight rows an
// ldmatrix reads at one 16-B chunk fall in eight different bank groups.
constexpr int kWdPb = 32;                        // positions a staged block
constexpr int kWdRowP = 2 * kMaxDkTiled + 16;    // bytes of a staged q or k row
constexpr int kWdBlockP = kWdPb * kWdRowP;       // a staged block (33,280 B)
constexpr int kWdVRowP = kWdRow + 16;            // bytes of a staged v row
constexpr int kWdVP = kMaxC * kWdVRowP;          // a chunk's v slice (18,432 B)
constexpr int kWdZs = kWd + 4;                   // row stride (floats) of the q C quarters
constexpr int kWdStThreads = 512;                // the state kernel's threads: 16 warps

__device__ __forceinline__ uint32_t p_off(int r, int c) { return r * kWdRowP + (c << 4); }
__device__ __forceinline__ uint32_t pv_off(int r, int c) { return r * kWdVRowP + (c << 4); }

struct WideStateSmem {
  static constexpr int kStages = 3 * kWdBlockP;       // a ring of three staged blocks
  static constexpr int kV = 2 * kWdVP;                // v slices of two chunks
  static constexpr int kZ = 4 * kWdPb * kWdZs * 4;    // the four Dk quarters' q C
  static constexpr int kTotal = kStages + kV + kZ + 4 * (kMaxDkTiled + 6 * kMaxC + 4);
};

// the raw gates of positions c0 .. c0 + chunk - 1: i at g[0 ..), f at g[kMaxC ..)
__device__ __forceinline__ void wide_stage_gates(const WideArgs& a, float* g, int b, int h, int c0) {
  const int t = threadIdx.x, C = a.chunk;
  for (int i = t; i < 2 * C; i += kWdStThreads) {
    const int r = i % C, pos = c0 + r;
    const bool ok = pos < a.s;
    const float* src = i < C ? a.ig : a.fg;
    cp_async4(smem_addr(g + (i < C ? 0 : kMaxC) + r),
              src + (ok ? ((size_t)b * a.s + pos) * a.h + h : 0), ok);
  }
}

// Stage block g of a slice's stream: each chunk is nqb blocks of q, then
// nqb blocks of k (32 positions over all of Dk; nqb = chunk / 32, rounded
// up); its first block brings the chunk's v slice and gates along. Rows
// past S and columns past Dk or the slice zero. Thread t copies row t / 16,
// 16-B chunks t % 16, t % 16 + 16, ... (v: row t / 8 and t / 8 + 64, chunk
// t % 8), no division by a runtime width.
__device__ __forceinline__ void wide_state_stage(const WideArgs& a, char* stg, char* vbuf,
                                                 float* graw, int g, int nqb, int dkp, int b,
                                                 int h, int dv0, int dvt) {
  const int t = threadIdx.x;
  const int per = 2 * nqb, ci = g / per, r = g - ci * per, pb = r < nqb ? r : r - nqb;
  const int c0 = ci * a.chunk, pos0 = c0 + kWdPb * pb;
  const int nr = min(kWdPb, a.chunk - kWdPb * pb);
  char* st = stg + (g % 3) * kWdBlockP;
  char* vt = vbuf + (ci & 1) * kWdVP;
  const size_t row = (size_t)a.h * a.dk, vrow = (size_t)a.h * a.dv;
  const bf16* src = (r < nqb ? a.q : a.k) + ((size_t)b * a.s * a.h + h) * a.dk;
  const bf16* vsrc = a.v + ((size_t)b * a.s * a.h + h) * a.dv + dv0;
  if (r == 0) wide_stage_gates(a, graw + (ci & 1) * 2 * kMaxC, b, h, c0);
  const int rr = t >> 4, pos = pos0 + rr;
  if (a.vec) {
    if (rr < nr) {
      const uint32_t sa = smem_addr(st) + rr * kWdRowP;
      const bf16* gp = src + (size_t)(pos < a.s ? pos : 0) * row;
      for (int c = t & 15; c < (dkp >> 3); c += 16) {
        const bool ok = pos < a.s && 8 * c < a.dk;
        cp_async16(sa + (c << 4), gp + (ok ? 8 * c : 0), ok);
      }
    }
    if (r == 0) {
      for (int vr = t >> 3; vr < a.chunk; vr += kWdStThreads / 8) {
        const int c = t & 7, vp = c0 + vr;
        const bool ok = vp < a.s && 8 * c < dvt;
        cp_async16(smem_addr(vt) + pv_off(vr, c), vsrc + (ok ? (size_t)vp * vrow + 8 * c : 0), ok);
      }
    }
  } else {
    if (rr < nr) {
      for (int d = t & 15; d < dkp; d += 16) {
        const bool ok = pos < a.s && d < a.dk;
        *reinterpret_cast<bf16*>(st + p_off(rr, d >> 3) + 2 * (d & 7)) =
            ok ? src[(size_t)pos * row + d] : __float2bfloat16(0.0f);
      }
    }
    if (r == 0) {
      for (int vr = t >> 3; vr < a.chunk; vr += kWdStThreads / 8) {
        const int vp = c0 + vr;
        for (int d = t & 7; d < kWd; d += 8) {
          const bool ok = vp < a.s && d < dvt;
          *reinterpret_cast<bf16*>(vt + pv_off(vr, d >> 3) + 2 * (d & 7)) =
              ok ? vsrc[(size_t)vp * vrow + d] : __float2bfloat16(0.0f);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWdStThreads, 1) mlstm_wide_state_kernel(WideArgs a) {
  using L = WideStateSmem;
  extern __shared__ __align__(128) char wsm[];
  char* stg = wsm;
  char* vbuf = stg + L::kStages;
  float* zs = reinterpret_cast<float*>(vbuf + L::kV);  // [4][kWdPb][kWdZs]
  float* nst = zs + 4 * kWdPb * kWdZs;                  // n (this slice's Dk tiles)
  float* graw = nst + kMaxDkTiled;                      // 2 chunks x (i, f)
  float* inter = graw + 4 * kMaxC;
  float* ew = inter + kMaxC;
  float* sc = ew + kMaxC;  // [0] decay

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gr = lane >> 2, tq = lane & 3;
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_sl = gridDim.x, dv0 = x * kWd, dvt = min(kWd, a.dv - dv0);
  const int C = a.chunk;
  const int dkp = (a.dk + kWd - 1) / kWd * kWd, n_kt = dkp / kWd;
  const int nks = dkp >> 6;  // k-steps of 16 in a quarter of dkp
  const int nqb = (C + kWdPb - 1) / kWdPb, per = 2 * nqb;
  const int n_chunks = (a.s + C - 1) / C, sp = n_chunks * C, total = n_chunks * per;
  const bool norm = a.normalize != 0;
  const size_t bh = (size_t)b * a.h + h;
  // warp (mt, dq): C^T rows (Dv) 16 mt .. 16 mt + 15 of the slice, columns
  // (Dk) dq dkp / 4 + 8 n + 2 tq (+1), n < 2 nks
  const int mt = warp & 3, dq = warp >> 2, kc0 = 2 * nks * dq;
  // n: this slice's Dk tiles x, x + n_sl, ..., ncols columns in all
  const int ncols = x < n_kt ? kWd * ((n_kt - 1 - x) / n_sl + 1) : 0;
  const uint32_t stg_a = smem_addr(stg);

  float cst[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cst[n][e] = 0.0f;
  }
  for (int i = t; i < kMaxDkTiled; i += kWdStThreads) nst[i] = 0.0f;
  float m_prev = norm ? kNeg : 0.0f;  // warp 0's
  // n's column sums: thread t adds column t % ncols of rows t / ncols,
  // t / ncols + G, ... of the chunk's k blocks (G = 512 / ncols groups)
  const int ng = ncols ? kWdStThreads / ncols : 0;
  float nsum = 0.0f;

  wide_state_stage(a, stg, vbuf, graw, 0, nqb, dkp, b, h, dv0, dvt);
  cp_async_commit();
  if (total > 1) wide_state_stage(a, stg, vbuf, graw, 1, nqb, dkp, b, h, dv0, dvt);
  cp_async_commit();
  for (int g = 0; g < total; ++g) {
    const int ci = g / per, r = g - ci * per, pb = r < nqb ? r : r - nqb;
    const int c0 = ci * C, p0 = kWdPb * pb;  // the block's first row in the chunk
    const int nr = min(kWdPb, C - p0);
    char* st = stg + (g % 3) * kWdBlockP;
    const uint32_t sa = stg_a + (g % 3) * kWdBlockP;
    cp_async_wait<1>();
    __syncthreads();  // block g staged; block g - 1's stage free
    if (g + 2 < total) wide_state_stage(a, stg, vbuf, graw, g + 2, nqb, dkp, b, h, dv0, dvt);
    cp_async_commit();

    if (r == 0) {
      // ---- the chunk's gates: warp 0, 4 positions a lane ----
      if (warp == 0) {
        const float* gi = graw + (ci & 1) * 2 * kMaxC;
        const float* gf = gi + kMaxC;
        float li[4], p[4], F[4], pm[4], w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * lane + e;
          const bool ok = j < C && c0 + j < a.s;
          const float fv = ok ? gf[j] : a.f_pad;
          const float lf = j < C ? (norm ? log_sigmoid(fv) : fv) : 0.0f;
          li[e] = ok ? gi[j] : kNeg;
          p[e] = e == 0 ? lf : __fadd_rn(p[e - 1], lf);
        }
        float xs = p[3];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, xs, o);
          if (lane >= o) xs = __fadd_rn(xs, y);
        }
        float excl = __shfl_up_sync(0xffffffffu, xs, 1);
        if (lane == 0) excl = 0.0f;
        const float f_end = __shfl_sync(0xffffffffu, __fadd_rn(excl, p[3]), (C >> 2) - 1);
        // the prefix max of i_s - F_s over s <= j
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          F[e] = __fadd_rn(excl, p[e]);
          const float gv = 4 * lane + e < C ? __fsub_rn(li[e], F[e]) : kNeg;
          pm[e] = e == 0 ? gv : fmaxf(pm[e - 1], gv);
        }
        float y = pm[3];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, y, o);
          if (lane >= o) y = fmaxf(y, u);
        }
        float pex = __shfl_up_sync(0xffffffffu, y, 1);
        if (lane == 0) pex = kNeg;
        float wmax = kNeg;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * lane + e;
          w[e] = __fadd_rn(__fsub_rn(f_end, F[e]), li[e]);
          if (j >= C) continue;
          const float mr = norm ? fmaxf(__fadd_rn(F[e], fmaxf(pex, pm[e])),
                                        __fadd_rn(F[e], m_prev))
                                : 0.0f;
          const float it = expf(__fsub_rn(__fadd_rn(F[e], m_prev), mr));
          inter[j] = it;
          wmax = fmaxf(wmax, w[e]);
          if (x == 0) {
            float* rec = a.gates + bh * 4 * sp + c0 + j;
            rec[0] = __fmul_rn(F[e], kLog2e);
            rec[sp] = __fmul_rn(__fsub_rn(li[e], F[e]), kLog2e);
            rec[2 * sp] = __fmul_rn(mr, kLog2e);
            rec[3 * sp] = it;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
        const float m_new = norm ? fmaxf(__fadd_rn(m_prev, f_end), wmax) : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * lane + e < C) ew[4 * lane + e] = expf(__fsub_rn(w[e], m_new));
        }
        if (lane == 0) sc[0] = expf(__fsub_rn(__fadd_rn(m_prev, f_end), m_new));
        m_prev = m_new;
      }
      __syncthreads();
    }

    if (r < nqb) {
      // ---- a block of q: this warp's share of C^T q^T (C before the
      //      chunk, in bf16); this slice's share of q . n ----
      float zacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) zacc[n][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nks) {
          uint32_t af[4];
          c_to_a(cst, kk, af);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (16 * np < nr) {
              uint32_t bb[4];
              ldsm_x4(sa + p_off(16 * np + l7 + 8 * l16, kc0 + 2 * kk + l8), bb);
              mma16816(zacc[2 * np], af, bb[0], bb[1]);
              mma16816(zacc[2 * np + 1], af, bb[2], bb[3]);
            }
          }
        }
      }
      // rows dv = 16 mt + gr (+8), positions 8 n + 2 tq (+1)
      float* zq = zs + dq * kWdPb * kWdZs;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          zq[(8 * n + 2 * tq + (e & 1)) * kWdZs + 16 * mt + gr + 8 * (e >> 1)] = zacc[n][e];
        }
      }
      if (norm) {  // q . n over this slice's columns: 16 threads a row
        const int rr = t >> 4, part = t & 15;
        float acc = 0.0f;
        if (rr < nr) {
#pragma unroll 4
          for (int c = part; c < ncols; c += 16) {
            const int d = kWd * (x + n_sl * (c >> 6)) + (c & 63);
            const float qv =
                __bfloat162float(*reinterpret_cast<const bf16*>(st + p_off(rr, d >> 3) + 2 * (d & 7)));
            acc = __fmaf_rn(qv, nst[d], acc);
          }
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
        if (part == 0 && rr < nr) a.qn[(bh * n_sl + x) * sp + c0 + p0 + rr] = acc;
      }
      __syncthreads();
      {  // z: row t / 16, columns 4 (t % 16) .. + 3, the quarters in order
        const int rr = t >> 4, col = 4 * (t & 15), pos = c0 + p0 + rr;
        if (rr < nr && pos < a.s && col < dvt) {
          const float it = inter[p0 + rr];
          float zv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* zr = zs + rr * kWdZs + col + e;
            const float qcv = __fadd_rn(__fadd_rn(__fadd_rn(zr[0], zr[kWdPb * kWdZs]),
                                                  zr[2 * kWdPb * kWdZs]),
                                        zr[3 * kWdPb * kWdZs]);
            zv[e] = __fmul_rn(it, __fmul_rn(qcv, a.scale));
          }
          float* zp = a.z + (((size_t)b * a.s + pos) * a.h + h) * a.dv + dv0 + col;
          if (a.vec) {
            *reinterpret_cast<float4*>(zp) = make_float4(zv[0], zv[1], zv[2], zv[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e < dvt) zp[e] = zv[e];
            }
          }
        }
      }
    } else {
      // ---- a block of k: kw = k exp(w - m_new) in bf16, in place; then
      //      C^T = decay C^T + V^T kw, and n's column sums ----
      for (int c = t & 15; (t >> 4) < nr && c < (dkp >> 3); c += 16) {
        const int rr = t >> 4;
        char* pp = st + p_off(rr, c);
        const uint4 raw = *reinterpret_cast<const uint4*>(pp);
        const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float wr = ew[p0 + rr];
        uint4 res;
        uint32_t* rp = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(kv[e]);
          rp[e] = pack_bf16(__fmul_rn(f.x, wr), __fmul_rn(f.y, wr));
        }
        *reinterpret_cast<uint4*>(pp) = res;
      }
      __syncthreads();
      const float dc = sc[0];
      if (pb == 0) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cst[n][e] = __fmul_rn(cst[n][e], dc);
        }
      }
      const uint32_t vs = smem_addr(vbuf + (ci & 1) * kWdVP);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (16 * ks < nr) {
          uint32_t aa[4];
          ldsm_x4_t(vs + pv_off(p0 + 16 * ks + l7 + 8 * l16, 2 * mt + l8), aa);
#pragma unroll
          for (int j2 = 0; j2 < 8; ++j2) {
            if (j2 < nks) {
              uint32_t bb[4];
              ldsm_x4_t(sa + p_off(16 * ks + l7 + 8 * l8, kc0 + 2 * j2 + l16), bb);
              mma16816(cst[2 * j2], aa, bb[0], bb[1]);
              mma16816(cst[2 * j2 + 1], aa, bb[2], bb[3]);
            }
          }
        }
      }
      if (norm && ncols) {
        const bool in = t < ng * ncols;
        const int c = t % ncols, d = kWd * (x + n_sl * (c >> 6)) + (c & 63);
        for (int rr = t / ncols; in && rr < nr; rr += ng) {
          nsum = __fadd_rn(nsum, __bfloat162float(*reinterpret_cast<const bf16*>(
                                     st + p_off(rr, d >> 3) + 2 * (d & 7))));
        }
        if (pb == nqb - 1) {  // n = decay n + the groups' sums, in group order
          if (in) zs[t] = nsum;
          nsum = 0.0f;
          __syncthreads();
          if (t < ncols) {
            float sum = 0.0f;
            for (int gi = 0; gi < ng; ++gi) sum = __fadd_rn(sum, zs[gi * ncols + t]);
            nst[d] = __fadd_rn(__fmul_rn(dc, nst[d]), sum);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

struct WideOutSmem {
  static constexpr int kStages = 4 * kWdTile;     // 2 stages of a q and a k tile (then v)
  static constexpr int kS = kMaxC * kTcVRow;      // the scores in bf16
  static constexpr int kTotal = kStages + kS + 4 * 6 * kMaxC;
};

__global__ void __launch_bounds__(kTcThreads, 2) mlstm_wide_out_kernel(WideArgs a) {
  using L = WideOutSmem;
  extern __shared__ __align__(128) char wsm[];
  char* stg = wsm;
  char* ssb = stg + L::kStages;
  float* f2 = reinterpret_cast<float*>(ssb + L::kS);  // F log2 e
  float* a2 = f2 + kMaxC;                              // (i - F) log2 e
  float* m2 = a2 + kMaxC;                              // m_j log2 e
  float* inter = m2 + kMaxC;
  float* qn = inter + kMaxC;
  float* nrm = qn + kMaxC;
  float* red = reinterpret_cast<float*>(stg);          // the hh = 1 warps' scores

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gr = lane >> 2, tq = lane & 3;
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = a.chunk, n_str = C >> 4, c0 = ci * C;
  const int n_kt = (a.dk + kWd - 1) / kWd, n_vt = (a.dv + kWd - 1) / kWd;
  const int sp = gridDim.x * C;
  const bool norm = a.normalize != 0;
  const size_t bh = (size_t)b * a.h + h;
  const uint32_t stg_a = smem_addr(stg), ssb_a = smem_addr(ssb);

  wide_stage_qk(a, stg, b, h, c0, 0);
  cp_async_commit();
  for (int j = t; j < C; j += kTcThreads) {
    const float* rec = a.gates + bh * 4 * sp + c0 + j;
    f2[j] = rec[0];
    a2[j] = rec[sp];
    m2[j] = rec[2 * sp];
    inter[j] = rec[3 * sp];
    float qs = 0.0f;  // q . n: the Dv slices' shares, in slice order
    for (int x = 0; norm && x < n_vt; ++x) qs = __fadd_rn(qs, a.qn[(bh * n_vt + x) * sp + c0 + j]);
    qn[j] = __fmul_rn(a.scale, qs);
  }

  // warp (p, hh): strips sb = n_str - 1 - p (tiles 0 .. sb) and, where
  // sa = p < sb, sa (tiles 0 .. sa); score tile i of sb is slot i, of sa
  // slot nb + i
  const int p = warp & 3, hh = warp >> 2;
  const int sa = p, sb = n_str - 1 - p;
  const bool act = sb >= sa;
  const int nb = act ? sb + 1 : 0;
  const int ntl = nb + (act && sa < sb ? sa + 1 : 0);
  float acc[kWdMaxTiles][2][4];
#pragma unroll
  for (int i = 0; i < kWdMaxTiles; ++i) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  // ---- the scores q k^T over the Dk tiles ----
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt staged; the other stage free
    if (kt + 1 < n_kt) wide_stage_qk(a, stg + ((kt + 1) & 1) * 2 * kWdTile, b, h, c0, kt + 1);
    cp_async_commit();
    if (act) {
      const uint32_t qs = stg_a + (kt & 1) * 2 * kWdTile, ks = qs + kWdTile;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * hh + k2;
        uint32_t qa[4] = {0, 0, 0, 0}, qb[4];
        ldsm_x4(qs + w_off(16 * sb + l7 + 8 * l8, 2 * kk + l16), qb);
        if (ntl > nb) ldsm_x4(qs + w_off(16 * sa + l7 + 8 * l8, 2 * kk + l16), qa);
#pragma unroll
        for (int i = 0; i < kWdMaxTiles; ++i) {
          if (i < ntl) {
            const bool in_b = i < nb;
            const int kt_ = in_b ? i : i - nb;
            uint32_t A[4], bb[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) A[e] = in_b ? qb[e] : qa[e];
            ldsm_x4(ks + w_off(16 * kt_ + l7 + 8 * l16, 2 * kk + l8), bb);
            mma16816(acc[i][0], A, bb[0], bb[1]);
            mma16816(acc[i][1], A, bb[2], bb[3]);
          }
        }
      }
    }
  }
  __syncthreads();  // every tile read: the stages hold the reduction
  if (act && hh == 1) {
#pragma unroll
    for (int i = 0; i < kWdMaxTiles; ++i) {
      if (i < ntl) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(((p * kWdMaxTiles + i) * 2 + n) * 4 + e) * 32 + lane] = acc[i][n][e];
        }
      }
    }
  }
  __syncthreads();
  if (act && hh == 0) {
    // ---- S: the two halves' sums, weighted where s <= j; the row sums ----
    float rsb[2] = {0.0f, 0.0f}, rsa[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kWdMaxTiles; ++i) {
      if (i < ntl) {
        const bool in_b = i < nb;
        const int strip = in_b ? sb : sa, kt_ = in_b ? i : i - nb;
        const int r_lo = 16 * strip + gr;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s_ = 16 * kt_ + 8 * n + 2 * tq + (e & 1);
            const int j = r_lo + 8 * (e >> 1);
            const float x = __fmul_rn(
                __fadd_rn(acc[i][n][e], red[(((p * kWdMaxTiles + i) * 2 + n) * 4 + e) * 32 + lane]),
                a.scale);
            const float val =
                s_ <= j ? __fmul_rn(x, ex2(__fsub_rn(__fadd_rn(f2[j], a2[s_]), m2[j]))) : 0.0f;
            acc[i][n][e] = val;
            if (in_b) {
              rsb[e >> 1] = __fadd_rn(rsb[e >> 1], val);
            } else {
              rsa[e >> 1] = __fadd_rn(rsa[e >> 1], val);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<uint32_t*>(ssb + v_off(r_lo + 8 * half, 2 * kt_ + n) + 4 * tq) =
                pack_bf16(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
          }
        }
      }
    }
    if (norm) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          rsb[half] = __fadd_rn(rsb[half], __shfl_xor_sync(0xffffffffu, rsb[half], o));
          rsa[half] = __fadd_rn(rsa[half], __shfl_xor_sync(0xffffffffu, rsa[half], o));
        }
      }
      if (tq == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && ntl == nb) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 16 * (u == 0 ? sb : sa) + gr + 8 * half;
            const float rs = u == 0 ? rsb[half] : rsa[half];
            const float den = __fadd_rn(rs, __fmul_rn(inter[j], qn[j]));
            nrm[j] = __fadd_rn(fmaxf(fabsf(den), ex2(-m2[j])), a.eps);
          }
        }
      }
    }
  }
  __syncthreads();  // S and the normaliser written; the stages free

  // ---- S V + z over the Dv tiles: rows of strips sb, sa, columns 32 hh .. ----
  wide_stage_v(a, stg, b, h, c0, 0);
  cp_async_commit();
  for (int vt = 0; vt < n_vt; ++vt) {
    cp_async_wait<0>();
    __syncthreads();  // tile vt staged; the other stage free
    if (vt + 1 < n_vt) wide_stage_v(a, stg + ((vt + 1) & 1) * 2 * kWdTile, b, h, c0, kWd * (vt + 1));
    cp_async_commit();
    if (!act) continue;
    const uint32_t vs = stg_a + (vt & 1) * 2 * kWdTile;
    // this thread's z, loaded ahead of the products
    float2 zz[2][2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = c0 + 16 * (u == 0 ? sb : sa) + gr + 8 * half;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = kWd * vt + 32 * hh + 8 * n + 2 * tq;
          const bool ok = a.vec && (u == 0 || ntl > nb) && pos < a.s && col < a.dv;
          zz[u][half][n] = ok ? *reinterpret_cast<const float2*>(
                                    a.z + (((size_t)b * a.s + pos) * a.h + h) * a.dv + col)
                              : make_float2(0.0f, 0.0f);
        }
      }
    }
    float o[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[u][n][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && ntl == nb) continue;
      const int strip = u == 0 ? sb : sa;
      for (int kt_ = 0; kt_ <= strip; ++kt_) {
        uint32_t sf[4];
        ldsm_x4(ssb_a + v_off(16 * strip + l7 + 8 * l8, 2 * kt_ + l16), sf);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bb[4];
          ldsm_x4_t(vs + w_off(16 * kt_ + l7 + 8 * l8, 2 * (2 * hh + jp) + l16), bb);
          mma16816(o[u][2 * jp], sf, bb[0], bb[1]);
          mma16816(o[u][2 * jp + 1], sf, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && ntl == nb) continue;
      const int strip = u == 0 ? sb : sa;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * strip + gr + 8 * half, pos = c0 + j;
        if (pos >= a.s) continue;
        const float nj = nrm[j];
        const size_t base = (((size_t)b * a.s + pos) * a.h + h) * a.dv;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = kWd * vt + 32 * hh + 8 * n + 2 * tq;
          if (col >= a.dv) continue;
          if (a.vec) {
            const float2 zv = zz[u][half][n];
            float x0 = __fadd_rn(o[u][n][2 * half], zv.x), x1 = __fadd_rn(o[u][n][2 * half + 1], zv.y);
            if (norm) {
              x0 = __fdiv_rn(x0, nj);
              x1 = __fdiv_rn(x1, nj);
            }
            *reinterpret_cast<uint32_t*>(a.out + base + col) = pack_bf16(x0, x1);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (col + e >= a.dv) continue;
              float x = __fadd_rn(o[u][n][2 * half + e], a.z[base + col + e]);
              if (norm) x = __fdiv_rn(x, nj);
              a.out[base + col + e] = __float2bfloat16(x);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

int wide_prepare() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mlstm_wide_state_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           WideStateSmem::kTotal);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(mlstm_wide_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WideOutSmem::kTotal);
    }
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  return 0;
}

int launch_wide(const WideArgs& a, int batch, cudaStream_t stream) {
  int err = wide_prepare();
  if (err) return err;
  const int n_sl = (a.dv + kWd - 1) / kWd;
  const dim3 g1(n_sl, a.h, batch);
  mlstm_wide_state_kernel<<<g1, kWdStThreads, WideStateSmem::kTotal, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 g2((a.s + a.chunk - 1) / a.chunk, a.h, batch);
  mlstm_wide_out_kernel<<<g2, kTcThreads, WideOutSmem::kTotal, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest Dk and chunk the kernels take.
int mlstm_chunk_limits(int* max_dk, int* max_chunk) {
  *max_dk = kMaxDkTiled;
  *max_chunk = kMaxC;
  return 0;
}

// Whether a call runs the tensor-core pair past Dk 64 (mlstm_wide_state_kernel,
// mlstm_wide_out_kernel): bf16, Dk 65 to 512, a chunk that is a multiple of
// 16, either flag.
int mlstm_chunk_uses_wide(int dtype, int chunk, int dk) {
  return dtype == 1 && dk > kMaxDk && dk <= kMaxDkTiled && chunk % 16 == 0;
}

// Whether a call runs the Dk-tiled kernel: past Dk 64, every call that
// does not run the tensor-core pair (float32; bf16 with another chunk).
int mlstm_chunk_uses_tiled(int dtype, int chunk, int dk) {
  return dk > kMaxDk && !mlstm_chunk_uses_wide(dtype, chunk, dk);
}

// Whether a call runs the tensor-core SSD kernel: bf16, normalize = 0, a
// chunk that is a multiple of 16 and Dk up to 64.
int mlstm_chunk_uses_mma(int dtype, int normalize, int chunk, int dk) {
  return dtype == 1 && normalize == 0 && chunk % 16 == 0 && dk <= kMaxDk;
}

// float32 scratch the launch needs (0 but for the tensor-core pair): z
// [B, S, H, Dv], then the gates [B, H, 4, Sp] and the Dv slices' shares of
// q . n [B, H, ceil(Dv / 64), Sp], Sp the chunks' positions.
long long mlstm_chunk_scratch_floats(int batch, int s, int h, int dk, int dv, int chunk,
                                     int dtype) {
  if (chunk < 1 || !mlstm_chunk_uses_wide(dtype, chunk, dk)) return 0;
  const long long sp = (long long)((s + chunk - 1) / chunk) * chunk;
  return (long long)batch * s * h * dv + (4LL + (dv + kWd - 1) / kWd) * batch * h * sp;
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

// The tensor-core pair's resident blocks an SM and dynamic shared memory a
// block: [0] mlstm_wide_state_kernel, [1] mlstm_wide_out_kernel.
int mlstm_chunk_wide_occupancy(int* blocks_per_sm, int* smem_bytes) {
  int err = wide_prepare();
  if (err) return err;
  smem_bytes[0] = WideStateSmem::kTotal;
  smem_bytes[1] = WideOutSmem::kTotal;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mlstm_wide_state_kernel, kWdStThreads, WideStateSmem::kTotal);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm + 1, mlstm_wide_out_kernel, kTcThreads, WideOutSmem::kTotal);
}

// dtype: 0 float32, 1 bfloat16. scratch: mlstm_chunk_scratch_floats floats
// (null where that is 0). Returns a cudaError_t.
int mlstm_chunk_launch(const void* q, const void* k, const void* v, const float* ig,
                       const float* fg, void* out, float* scratch, int batch, int s, int h,
                       int dk, int dv, int chunk, int normalize, float scale, float eps,
                       float f_pad, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || h < 1 || h > 65535 || dk < 1 ||
      dk > kMaxDkTiled || dv < 1 || chunk < 1 || chunk > kMaxC || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (mlstm_chunk_uses_wide(dtype, chunk, dk)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long sp = (long long)((s + chunk - 1) / chunk) * chunk;
    float* gates = scratch + (long long)batch * s * h * dv;
    WideArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), ig, fg, static_cast<bf16*>(out), scratch, gates,
               gates + 4LL * batch * h * sp, s, h, dk, dv, chunk, normalize, scale, eps, f_pad,
               aligned && dk % 8 == 0 && dv % 8 == 0};
    return launch_wide(a, batch, st);
  }
  if (mlstm_chunk_uses_tiled(dtype, chunk, dk)) {
    MlstmArgs a{q, k, v, ig, fg, out, s, h, dk, dv, chunk, normalize, scale, eps, f_pad};
    return dtype == 0 ? launch_tiled<float>(a, batch, st)
                      : launch_tiled<__nv_bfloat16>(a, batch, st);
  }
  if (mlstm_chunk_uses_mma(dtype, normalize, chunk, dk)) {
    SsdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), ig, fg, static_cast<bf16*>(out),
              s, h, dk, dv, chunk, scale, f_pad, aligned && dk % 8 == 0 && dv % 8 == 0};
    return dk <= 16 ? launch_ssd<16>(a, batch, st) : launch_ssd<kMaxDk>(a, batch, st);
  }
  MlstmArgs a{q, k, v, ig, fg, out, s, h, dk, dv, chunk, normalize, scale, eps, f_pad};
  return dtype == 0 ? launch_dk<float>(a, batch, st) : launch_dk<__nv_bfloat16>(a, batch, st);
}

}  // extern "C"
