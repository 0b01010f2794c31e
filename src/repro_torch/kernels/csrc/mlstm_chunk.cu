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
// out) for ~4 GFLOP of products: bytes, ~0.07 ms at 3.35 TB/s.
//
// What the design does about it. This first kernel is simple: no tensor
// cores, float32 fused multiply-adds on the CUDA cores, one (batch, head,
// 64-wide slice of Dv) per block walking its chunks in order, as the TPU
// grid walks them; the slices of one head recompute the [c, c] scores
// (cheap at Dk 16) so that the state C [Dk, 64] fits in shared memory
// beside the chunk's q, k, v and scores, and B H Dv / 64 = 400 blocks fill
// the card at the serving shapes. Per chunk: the gates' inclusive cumsum
// (one thread, in order), the scores and row quantities with two threads
// per row, the [c, 64] output tile with a 4 x 8 register tile per thread
// (the scores times v plus the inter-chunk term q C), then the state
// update. The loads of a chunk are not overlapped with its compute
// (cp.async / TMA double buffering come later). Dk up to 64 and chunks up
// to 128 positions; xLSTM's Dk = 512 needs the state tiled over Dk too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Largest Dk and chunk the kernel takes.
int mlstm_chunk_limits(int* max_dk, int* max_chunk) {
  *max_dk = kMaxDk;
  *max_chunk = kMaxC;
  return 0;
}

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t.
int mlstm_chunk_launch(const void* q, const void* k, const void* v, const float* ig,
                       const float* fg, void* out, int batch, int s, int h, int dk, int dv,
                       int chunk, int normalize, float scale, float eps, float f_pad,
                       int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || h < 1 || h > 65535 || dk < 1 || dk > kMaxDk ||
      dv < 1 || chunk < 1 || chunk > kMaxC || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  MlstmArgs a{q, k, v, ig, fg, out, s, h, dk, dv, chunk, normalize, scale, eps, f_pad};
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? launch_dk<float>(a, batch, st) : launch_dk<__nv_bfloat16>(a, batch, st);
}

}  // extern "C"
