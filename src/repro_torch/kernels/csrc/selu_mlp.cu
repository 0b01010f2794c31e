// Fused SELU-MLP forward (the AALR ratio classifier), for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/selu_mlp.py: selu_mlp_pallas / _mlp_kernel. It computes
//   h = x;  h = selu(h W_i + b_i) for each hidden layer i < depth;
//   out = h W_depth + b_depth  (the linear head)
// in float32, and, when asked, writes every hidden layer's pre-activation
// h W_i + b_i to global memory for the autograd backward.
//
// What bounds it on the card. Per row the work is 2 (F_in H + (depth - 1) H^2
// + H f_out) operations against (F_in + f_out) * 4 bytes of row data: about
// 100,000 operations per 64 bytes at F_in 15, H 128, depth 4, so it is bound
// by operations, far above the memory roofline. Tensor cores are not used
// (the port keeps float32 products at full precision, TF32 off), so the bound
// is the 67 TFLOP/s fp32 rate of the CUDA cores.
//
// What the design does about it. One block owns a tile of kRows rows and has
// one thread per hidden unit. The tile's activations sit in shared memory,
// ping-ponged between layers, so nothing between the input and the logit
// touches device memory (the TPU kernel kept them in VMEM for the same
// reason). Each layer's weight matrix is staged into dynamic shared memory in
// chunks of rows (the whole 64 KB [128, 128] matrix at once at H = 128), the
// loads coalesced and all in flight together. Thread j then keeps column j's
// sums for every row of the tile in registers: per input unit k it reads one
// weight from shared memory and a float4 of four units of each row as a
// broadcast, so every weight read is used kRows times and every activation
// read by all H threads at once. Input widths are zero-padded to a multiple
// of 4 in shared memory; zero terms leave the sums unchanged.
//
// Rounding. Each sum runs in ascending k as a multiply then an add, each
// rounded (explicit __fmul_rn / __fadd_rn, built with --fmad=false), and the
// bias is added after the sum: exactly the order of the plain PyTorch version
// (repro_torch/kernels/ref.py selu_mlp), so a row's result does not depend on
// the other rows of the launch, and the kernel and the plain version differ
// only where expm1 rounds differently. SELU is scale * (z > 0 ? z : alpha *
// expm1(z)), as jax.nn.selu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;         // rows per block (one tile)
constexpr int kMaxHidden = 256;   // threads per block = hidden width
constexpr int kMaxIn = 256;       // widest input layer
constexpr int kMaxOut = 256;      // widest head
constexpr int kMaxLayers = 9;     // depth + 1
constexpr int kWeightFloats = 16384;  // 64 KB of staged weight rows
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
  int chunk;                       // weight rows staged per pass
};

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float selu(float z) {
  return z > 0.0f ? __fmul_rn(kScale, z)
                  : __fmul_rn(kScale, __fmul_rn(kAlpha, expm1f(z)));
}

// acc[r] = sum_k hin[r][k] * W[k][j] for k < din (din padded to 4 with
// zeros), ascending k, W staged through wsm in chunks of a.chunk rows.
__device__ __forceinline__ void layer_sums(
    const MlpArgs& a, const float* __restrict__ w, int din, int dout,
    const float* hin, float* wsm, float (&acc)[kRows]) {
  const int j = threadIdx.x;
  const int din4 = round4(din);
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int k0 = 0; k0 < din4; k0 += a.chunk) {
    const int kn = min(a.chunk, din4 - k0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < kn * dout; i += blockDim.x) {
      const int k = k0 + i / dout;
      wsm[i] = k < din ? __ldg(w + (size_t)k * dout + i % dout) : 0.0f;
    }
    __syncthreads();
    if (j < dout) {
      for (int k = 0; k < kn; k += 4) {
        const float w0 = wsm[(k + 0) * dout + j];
        const float w1 = wsm[(k + 1) * dout + j];
        const float w2 = wsm[(k + 2) * dout + j];
        const float w3 = wsm[(k + 3) * dout + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 h = *reinterpret_cast<const float4*>(hin + r * a.ld + k0 + k);
          float s = acc[r];
          s = __fadd_rn(s, __fmul_rn(h.x, w0));
          s = __fadd_rn(s, __fmul_rn(h.y, w1));
          s = __fadd_rn(s, __fmul_rn(h.z, w2));
          s = __fadd_rn(s, __fmul_rn(h.w, w3));
          acc[r] = s;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxHidden) selu_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* hbuf[2] = {smem, smem + kRows * a.ld};
  float* wsm = smem + 2 * kRows * a.ld;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.n - row0);

  // the tile's input rows, zero-padded to a multiple of 4 columns and to kRows
  const int f4 = round4(a.f_in);
  for (int i = threadIdx.x; i < kRows * f4; i += blockDim.x) {
    const int r = i / f4, c = i % f4;
    hbuf[0][r * a.ld + c] =
        (r < rows && c < a.f_in) ? __ldg(a.x + (size_t)(row0 + r) * a.f_in + c) : 0.0f;
  }

  float acc[kRows];
  int cur = 0;
  for (int layer = 0; layer < a.depth; ++layer) {
    const int din = layer == 0 ? a.f_in : a.hidden;
    layer_sums(a, a.w[layer], din, a.hidden, hbuf[cur], wsm, acc);
    const int j = threadIdx.x;
    const float bj = __ldg(a.b[layer] + j);
    float* hout = hbuf[cur ^ 1];
    float* pre = a.pre ? a.pre + ((size_t)layer * a.n + row0) * a.hidden : nullptr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float z = __fadd_rn(acc[r], bj);
      if (pre != nullptr && r < rows) pre[(size_t)r * a.hidden + j] = z;
      hout[r * a.ld + j] = selu(z);
    }
    cur ^= 1;
    __syncthreads();  // hout complete before the next layer reads it
  }

  // the linear head: one (row, output) pair per thread, ascending k
  const float* h = hbuf[cur];
  const float* wd = a.w[a.depth];
  const float* bd = a.b[a.depth];
  for (int i = threadIdx.x; i < rows * a.f_out; i += blockDim.x) {
    const int r = i / a.f_out, o = i % a.f_out;
    float s = 0.0f;
    for (int k = 0; k < a.hidden; ++k) {
      s = __fadd_rn(s, __fmul_rn(h[r * a.ld + k], __ldg(wd + (size_t)k * a.f_out + o)));
    }
    a.out[(size_t)(row0 + r) * a.f_out + o] = __fadd_rn(s, __ldg(bd + o));
  }
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

// weights / biases: host arrays of depth + 1 device pointers each.
int selu_mlp_launch(const float* x, const float* const* weights,
                    const float* const* biases, float* out, float* pre, int n,
                    int f_in, int hidden, int depth, int f_out, void* stream) {
  if (n < 1 || depth < 1 || depth >= kMaxLayers || hidden < 32 ||
      hidden > kMaxHidden || hidden % 32 != 0 || f_in < 1 || f_in > kMaxIn ||
      f_out < 1 || f_out > kMaxOut) {
    return (int)cudaErrorInvalidValue;
  }
  MlpArgs a{};
  a.x = x;
  for (int i = 0; i <= depth; ++i) {
    a.w[i] = weights[i];
    a.b[i] = biases[i];
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
  // weight rows per staged chunk: a multiple of 4 within 64 KB
  a.chunk = (kWeightFloats / hidden) & ~3;
  const size_t bytes = sizeof(float) * (2 * kRows * (size_t)a.ld + (size_t)a.chunk * hidden);
  static size_t attr_bytes = 0;
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        selu_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  const int blocks = (n + kRows - 1) / kRows;
  selu_mlp_kernel<<<blocks, hidden, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
