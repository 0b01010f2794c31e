// Fused SELU-MLP forward (the AALR ratio classifier), for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/selu_mlp.py: selu_mlp_pallas / _mlp_kernel. It computes
//   h = x;  h = selu(h W_i + b_i) for each hidden layer i < depth;
//   out = h W_depth + b_depth  (the linear head)
// in float32, and, when asked, writes every hidden layer's pre-activation
// h W_i + b_i to global memory for the autograd backward.
//
// Rounding, the contract that shapes everything else. Each sum runs in
// ascending k as a multiply then an add, each rounded (explicit __fmul_rn /
// __fadd_rn, built with --fmad=false), and the bias is added after the sum:
// exactly the order of the plain PyTorch version (repro_torch/kernels/ref.py
// selu_mlp), so a row's result does not depend on the other rows of the
// launch or on the tile it lands in, and the kernel and the plain version
// agree bit for bit. Tensor cores (even 3xTF32) and FMA would change that
// order, so they are not used. The k loop is never split; any tiling over
// rows and columns is free. SELU is scale * (z > 0 ? z : alpha * expm1(z)),
// as jax.nn.selu.
//
// What bounds it on the card. Per row the work is F_in H + (depth - 1) H^2
// + H f_out multiply-add pairs against (F_in + f_out) * 4 bytes of row
// data: bound by operations. Without FMA every pair is two executed
// instructions (FMUL, FADD), so the bound is the fp32 instruction rate: 2x the
// FMA roofline (0.025 ms at N = 8,192, F_in 15, 4 x 128).
//
// What the design does about it. A block owns a tile of TR = RG * RPT rows
// and has (H / 4) * RG threads: thread (cg, rg) keeps a register tile of
// RPT rows x 4 columns (columns 4 cg .. 4 cg + 3, rows rg * RPT ..), so per
// step of 4 k it reads 4 float4 of weights and RPT float4 of activations
// (broadcast: a warp shares its rows) from shared memory for 32 * RPT
// products. The tile's activations stay in shared memory, ping-ponged
// between layers, so nothing between the input and the logit touches
// device memory. The weights stream through a ring of kStages chunks of
// kKc rows in shared memory by cp.async (16-B copies; 4-B where a matrix
// is not 16-B aligned): the chunks of layer l + 1 are in flight while
// layer l computes, and the input tile comes with the first chunk. The
// launch picks (RG, RPT) from N, the widths and the SM count: the largest
// tile that still gives every SM a block (one wave of resident blocks at
// the calibration's N = 4,096 and 8,192), else the 4-row tile of 4 warps
// (the Section-5 chains, N = 4), where one block's path through the 200 KB
// of weights is the whole time. The head, f_out columns (1 on the
// calibration path), is one ascending sum per (row, output) over the last
// activations, its weights read from L1/L2. One launch a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_helpers.cuh"

namespace {

constexpr int kMaxHidden = 256;   // widest hidden layer
constexpr int kMaxIn = 256;       // widest input layer
constexpr int kMaxOut = 256;      // widest head
constexpr int kMaxLayers = 9;     // depth + 1
constexpr int kKc = 32;           // weight rows a staged chunk
constexpr int kStages = 4;        // chunks in the ring
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt into (H100)
constexpr float kAlpha = 1.6732632423543772848170429916717f;
constexpr float kScale = 1.0507009873554804934193349852946f;

struct MlpArgs {
  const float* x;                  // [N, f_in]
  const float* w[kMaxLayers];      // [F_i, F_i+1] row-major
  const float* b[kMaxLayers];      // [F_i+1]
  float* out;                      // [N, f_out]
  float* pre;                      // [depth, N, hidden] or null
  int n, f_in, hidden, depth, f_out;
  int ld;                          // activation row stride in shared memory
  int c0;                          // chunks of layer 0: ceil(round4(f_in) / kKc)
  unsigned vec;                    // bit l: w[l] 16-B aligned
};

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float selu(float z) {
  return z > 0.0f ? __fmul_rn(kScale, z)
                  : __fmul_rn(kScale, __fmul_rn(kAlpha, expm1f(z)));
}

// acc[c] = acc[c] + h * w[c], each rounded
__device__ __forceinline__ void mul_add4(float* acc, float h, const float4& w) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(h, w.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(h, w.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(h, w.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(h, w.w));
}

// Weight chunk q of the stream (layer 0's rows zero-padded to a multiple
// of kKc, then kKc-row slices of each hidden layer): its layer and first row.
__device__ __forceinline__ void chunk_of(const MlpArgs& a, int q, int& layer, int& k0) {
  if (q < a.c0) {
    layer = 0;
    k0 = q * kKc;
  } else {
    const int per = a.hidden / kKc, r = q - a.c0;
    layer = 1 + r / per;
    k0 = (r - (r / per) * per) * kKc;
  }
}

template <int RG, int RPT>
__global__ void __launch_bounds__(kMaxHidden / 4 * RG) selu_mlp_kernel(MlpArgs a) {
  constexpr int TR = RG * RPT;
  extern __shared__ __align__(16) float smem[];
  float* const act0 = smem;
  float* const act1 = smem + TR * a.ld;
  float* ring = smem + 2 * TR * a.ld;
  const int H = a.hidden, ncg = H >> 2, nthreads = ncg * RG;
  const int t = threadIdx.x, cg = t % ncg, rg = t / ncg;
  const int row0 = blockIdx.x * TR;
  const int slot = kKc * H;
  const int n_chunks = a.c0 + (a.depth - 1) * (H / kKc);
  const int f4 = round4(a.f_in);

  // the tile's input rows, zero-filled past N and past f_in
  for (int i = t; i < TR * f4; i += nthreads) {
    const int r = i / f4, c = i - r * f4;
    const bool ok = row0 + r < a.n && c < a.f_in;
    cp_async4(smem_addr(act0 + r * a.ld + c),
              ok ? a.x + (size_t)(row0 + r) * a.f_in + c : a.x, ok);
  }

  // weight chunk q into its ring slot (rows past the layer's input width
  // zero-filled); one commit group per chunk, empty past the last
  auto stage_chunk = [&](int q) {
    if (q < n_chunks) {
      int layer, k0;
      chunk_of(a, q, layer, k0);
      const int din = layer == 0 ? a.f_in : H;
      const float* w = a.w[layer];
      const uint32_t dst = smem_addr(ring + (q % kStages) * slot + 4 * cg);
      if (a.vec >> layer & 1u) {
#pragma unroll
        for (int j = 0; j < kKc / RG; ++j) {
          const int r = rg + j * RG;
          const bool ok = k0 + r < din;
          cp_async16(dst + 4 * r * H, ok ? w + (size_t)(k0 + r) * H + 4 * cg : w, ok);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKc / RG; ++j) {
          const int r = rg + j * RG;
          const bool ok = k0 + r < din;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cp_async4(dst + 4 * (r * H + e), ok ? w + (size_t)(k0 + r) * H + 4 * cg + e : w, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) stage_chunk(q);

  float acc[RPT][4];
  float bias[4];
  int cur = 0;
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q (and the input tile) landed; chunk q - 1's slot is free
    stage_chunk(q + kStages - 1);
    int layer, k0;
    chunk_of(a, q, layer, k0);
    const int kn = layer == 0 ? min(kKc, f4 - k0) : kKc;
    if (k0 == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) bias[c] = __ldg(a.b[layer] + 4 * cg + c);
    }
    const float* hin = (cur ? act1 : act0) + rg * RPT * a.ld + k0;
    const float* ws = ring + (q % kStages) * slot + 4 * cg;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 4) {
      if (kk >= kn) break;
      const float4 w0 = *reinterpret_cast<const float4*>(ws + (kk + 0) * H);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + (kk + 1) * H);
      const float4 w2 = *reinterpret_cast<const float4*>(ws + (kk + 2) * H);
      const float4 w3 = *reinterpret_cast<const float4*>(ws + (kk + 3) * H);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(hin + r * a.ld + kk);
        mul_add4(acc[r], h.x, w0);
        mul_add4(acc[r], h.y, w1);
        mul_add4(acc[r], h.z, w2);
        mul_add4(acc[r], h.w, w3);
      }
    }
    if (k0 + kn == (layer == 0 ? f4 : H)) {  // the layer's last chunk: bias, SELU
      float* hout = cur ? act0 : act1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = rg * RPT + r, row = row0 + lr;
        float4 z;
        z.x = __fadd_rn(acc[r][0], bias[0]);
        z.y = __fadd_rn(acc[r][1], bias[1]);
        z.z = __fadd_rn(acc[r][2], bias[2]);
        z.w = __fadd_rn(acc[r][3], bias[3]);
        if (a.pre != nullptr && row < a.n) {
          *reinterpret_cast<float4*>(a.pre + ((size_t)layer * a.n + row) * H + 4 * cg) = z;
        }
        *reinterpret_cast<float4*>(hout + lr * a.ld + 4 * cg) =
            make_float4(selu(z.x), selu(z.y), selu(z.z), selu(z.w));
      }
      cur ^= 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last hidden layer's activations complete

  // the linear head: one (row, output) pair per thread, ascending k
  const float* h = cur ? act1 : act0;
  const float* wd = a.w[a.depth];
  const float* bd = a.b[a.depth];
  const int rows = min(TR, a.n - row0);
  for (int i = t; i < rows * a.f_out; i += nthreads) {
    const int r = i / a.f_out, o = i - r * a.f_out;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      s = __fadd_rn(s, __fmul_rn(h[r * a.ld + k], __ldg(wd + (size_t)k * a.f_out + o)));
    }
    a.out[(size_t)(row0 + r) * a.f_out + o] = __fadd_rn(s, __ldg(bd + o));
  }
}

size_t smem_bytes(int rows, int f_in, int hidden) {
  const int f4 = (f_in + 3) & ~3;
  const int ld = f4 > hidden ? f4 : hidden;
  return sizeof(float) * (2 * (size_t)rows * ld + (size_t)kStages * kKc * hidden);
}

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

// The tiles (row groups, rows a thread), largest first. (4, 1) is 4 warps
// at H 128: the small-N tile.
constexpr int kTiles[][2] = {{8, 8}, {8, 4}, {8, 2}, {8, 1}, {4, 1}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// The largest tile that fits a block's shared memory and still gives every
// SM a block, else the smallest that fits: where no tile fills the card,
// the shortest path through a block sets the time. (4, 1) fits at every
// width the kernel takes.
void choose_tile(int n, int f_in, int hidden, int* rg, int* rpt) {
  const int sms = sm_count();
  for (int i = 0; i < kNumTiles; ++i) {
    const int rows = kTiles[i][0] * kTiles[i][1];
    if (smem_bytes(rows, f_in, hidden) > (size_t)kMaxSmem) continue;
    *rg = kTiles[i][0];
    *rpt = kTiles[i][1];
    if ((n + rows - 1) / rows >= sms) return;
  }
}

template <int RG, int RPT>
int launch(const MlpArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(RG * RPT, a.f_in, a.hidden);
  static size_t attr_bytes[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || bytes > attr_bytes[dev]) {
    err = cudaFuncSetAttribute(
        selu_mlp_kernel<RG, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_bytes[dev] = bytes;
  }
  const int blocks = (a.n + RG * RPT - 1) / (RG * RPT);
  selu_mlp_kernel<RG, RPT><<<blocks, a.hidden / 4 * RG, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(int n, int f_in, int hidden, int depth, int f_out) {
  return n >= 1 && depth >= 1 && depth < kMaxLayers && hidden >= 32 && hidden <= kMaxHidden &&
         hidden % 32 == 0 && f_in >= 1 && f_in <= kMaxIn && f_out >= 1 && f_out <= kMaxOut;
}

}  // namespace

extern "C" {

// Largest widths the kernel takes; the wrapper checks against them.
int selu_mlp_limits(int* max_hidden, int* max_in, int* max_out, int* max_depth) {
  *max_hidden = kMaxHidden;
  *max_in = kMaxIn;
  *max_out = kMaxOut;
  *max_depth = kMaxLayers - 1;
  return 0;
}

// The tile selu_mlp_launch takes for n rows on the current device, as
// row_groups x rows_per_thread (a block's rows are their product). For
// reports; the launch chooses it itself.
int selu_mlp_tile(int n, int f_in, int hidden, int* row_groups, int* rows_per_thread) {
  if (!shape_ok(n, f_in, hidden, 1, 1)) return (int)cudaErrorInvalidValue;
  choose_tile(n, f_in, hidden, row_groups, rows_per_thread);
  return 0;
}

// weights / biases: host arrays of depth + 1 device pointers each.
int selu_mlp_launch(const float* x, const float* const* weights,
                    const float* const* biases, float* out, float* pre, int n,
                    int f_in, int hidden, int depth, int f_out, void* stream) {
  if (!shape_ok(n, f_in, hidden, depth, f_out)) return (int)cudaErrorInvalidValue;
  MlpArgs a{};
  a.x = x;
  for (int i = 0; i <= depth; ++i) {
    a.w[i] = weights[i];
    a.b[i] = biases[i];
    if (i < depth && ((uintptr_t)weights[i] & 15u) == 0) a.vec |= 1u << i;
  }
  a.out = out;
  a.pre = pre;
  a.n = n;
  a.f_in = f_in;
  a.hidden = hidden;
  a.depth = depth;
  a.f_out = f_out;
  const int f4 = (f_in + 3) & ~3;
  a.ld = f4 > hidden ? f4 : hidden;
  a.c0 = (f4 + kKc - 1) / kKc;
  int rg = 0, rpt = 0;
  choose_tile(n, f_in, hidden, &rg, &rpt);
  cudaStream_t st = (cudaStream_t)stream;
  if (rg == 8 && rpt == 8) return launch<8, 8>(a, st);
  if (rg == 8 && rpt == 4) return launch<8, 4>(a, st);
  if (rg == 8 && rpt == 2) return launch<8, 2>(a, st);
  if (rg == 8 && rpt == 1) return launch<8, 1>(a, st);
  return launch<4, 1>(a, st);
}

}  // extern "C"
