// Conv epilogue of the strict-f32 HMR on the card: in place on one conv's
// NCHW f32 output y (N, C, H, W), with the conv's folded bias b (C) and,
// for a bottleneck's last conv, the block's identity r (N, C, H, W):
//   y = y + b[c]                      (a downsample)
//   y = max(y + b[c], 0)              (the stem, each conv1 and conv2)
//   y = max((y + b[c]) + r, 0)        (each conv3)
// The f32 operations come in that order, each rounded once (__fadd_rn, no
// FMA can form), and max(v, 0) keeps v unless v < 0, as torch's relu_ does
// (NaN passes through): the kernel equals its plain version,
// ops/epilogue.conv_epilogue_plain, bit for bit.
//
// Replaces no TPU kernel: XLA fused the JAX package's BatchNorm, ReLU and
// residual add into its convolutions. On the card the strict-f32 HMR's
// BatchNorm is folded into each conv's weight and bias at load
// (models/resnet_int8.fold_resnet50_params), the conv runs bias-free through
// cuDNN on NCHW tensors, and this one pass takes the place of the BatchNorm,
// ReLU and add kernels that ran between two convs.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each output is read and written
// once (8 bytes) and each conv3 output reads one identity value (4 bytes)
// against 1-3 f32 operations: about 110 MB a 224x224 crop over the 53 convs
// of ResNet-50, 7.1 GB (2.1 ms) a 64-crop chunk.
//
// Design: one thread per 16-byte vector of y (and r), neighbouring threads
// on neighbouring vectors, so every load and store is a full coalesced
// 16-byte access. Blocks walk one sample's C*H*W values (blockIdx.y the
// sample, strided by gridDim.y past 65535 samples); a thread's channel is
// its first value's offset over H*W, so b[c] is one cached load for the
// vector. ResNet-50's 7x7 maps are 49 values a plane, not a multiple of 4,
// so there a vector may straddle two planes: its values past the plane's
// end take b[c + 1] (H*W >= 4, so at most one boundary a vector). Where the
// sample is not a whole number of vectors, H*W < 4, or a pointer is not
// 16-byte aligned, a scalar kernel (one value a thread) does the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kRes, bool kRelu>
__device__ __forceinline__ float finish(float y, float b, float r) {
  float v = __fadd_rn(y, b);
  if (kRes) v = __fadd_rn(v, r);
  if (kRelu) v = v < 0.0f ? 0.0f : v;
  return v;
}

template <bool kRes, bool kRelu>
__global__ void epilogue_vec_kernel(float* __restrict__ y, const float* __restrict__ bias,
                                    const float* __restrict__ res, int N, int HW, int chw4) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;  // vector within the sample
  if (v >= chw4) return;
  const int j = 4 * v;                                  // its first value
  const int c = j / HW;
  const int in_c = (c + 1) * HW - j;                    // its values in plane c: 1 or more
  const float bc = __ldg(bias + c);
  const float bn = in_c < 4 ? __ldg(bias + c + 1) : bc;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const int64_t at = (int64_t)n * chw4 + v;
    float4* yv = reinterpret_cast<float4*>(y) + at;
    const float4 t = *yv;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kRes) r = __ldg(reinterpret_cast<const float4*>(res) + at);
    float4 o;
    o.x = finish<kRes, kRelu>(t.x, bc, r.x);
    o.y = finish<kRes, kRelu>(t.y, in_c > 1 ? bc : bn, r.y);
    o.z = finish<kRes, kRelu>(t.z, in_c > 2 ? bc : bn, r.z);
    o.w = finish<kRes, kRelu>(t.w, in_c > 3 ? bc : bn, r.w);
    *yv = o;
  }
}

template <bool kRes, bool kRelu>
__global__ void epilogue_scalar_kernel(float* __restrict__ y, const float* __restrict__ bias,
                                       const float* __restrict__ res, int N, int HW, int chw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= chw) return;
  const float b = __ldg(bias + j / HW);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const int64_t at = (int64_t)n * chw + j;
    y[at] = finish<kRes, kRelu>(y[at], b, kRes ? __ldg(res + at) : 0.0f);
  }
}

template <bool kRes, bool kRelu>
void launch(float* y, const float* b, const float* r, int N, int C, int HW, bool vec,
            cudaStream_t st) {
  const int chw = C * HW;
  const int per = vec ? chw / 4 : chw;
  const dim3 grid((per + kThreads - 1) / kThreads, N < 65535 ? N : 65535);
  if (vec) {
    epilogue_vec_kernel<kRes, kRelu><<<grid, kThreads, 0, st>>>(y, b, r, N, HW, per);
  } else {
    epilogue_scalar_kernel<kRes, kRelu><<<grid, kThreads, 0, st>>>(y, b, r, N, HW, per);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C interface for ctypes. y and residual (nullptr for none) are
// contiguous (N, C, H, W) f32, bias (C) f32, all on the stream's device.
// Launches on `stream` (PyTorch's current stream), does not synchronise,
// allocates nothing, and returns the cudaGetLastError() code of the launch
// (0 on success).
extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* residual, int N,
                                    int C, int HW, int relu, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0) return 0;
  if ((int64_t)C * HW > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  const float* b = static_cast<const float*>(bias);
  const float* r = static_cast<const float*>(residual);
  const bool vec = (C * HW) % 4 == 0 && HW >= 4 && aligned16(y) && (!r || aligned16(r));
  if (r && relu) launch<true, true>(yf, b, r, N, C, HW, vec, st);
  else if (r) launch<true, false>(yf, b, r, N, C, HW, vec, st);
  else if (relu) launch<false, true>(yf, b, r, N, C, HW, vec, st);
  else launch<false, false>(yf, b, r, N, C, HW, vec, st);
  return (int)cudaGetLastError();
}

extern "C" const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
