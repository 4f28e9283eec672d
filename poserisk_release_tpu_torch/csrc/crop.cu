// Batched bbox crop: (B, H, W, 3) uint8 frames -> (B, S, S, 3) f32 or bf16
// in [0, 1], S = out_size (224 on the pose path).
//
// Replaces the TPU kernel crop_batch_pallas
// (poserisk_release_tpu/ops/resample_pallas.py:426, body _crop_kernel at
// :411, taps _taps_from_coords at :50 and coordinates _crop_coords at :232).
// The TPU kernel builds per-frame (S, H) row-tap and (W, S) column-tap
// matrices and runs two matmuls per channel, because a TPU has no hardware
// gather and its matrix unit is the fast path. Hopper gathers from L1/L2
// directly, so here each output pixel reads its 2x2 source taps itself.
// The semantics and the rounding rule are in resample_common.cuh (shared
// with the fused letterbox + crop kernel, letterbox_crop.cu).
//
// Two more entry points share the gather:
// * crop_window_launch is K3, replacing crop_batch_pallas_windowed
//   (resample_pallas.py:336, body _crop_win_kernel at :273, column taps
//   _window_col_taps at :254): the TPU kernel DMAs only a `window`-column
//   slice of each frame, from column xblk * 128 (xblk per frame, from the
//   box), and its column taps outside that slice match no matrix row, so
//   they are dropped. Here the same crop pixel gets weight 0 on such a tap
//   (resample_common.cuh, kWindow); inside the host-side guard
//   crop_window_fits no tap is dropped and K3 equals K1 bit for bit. A
//   gather already reads only the taps it needs, so the window saves no
//   bytes on Hopper: K3 is bound by the same bytes as K1.
// * crop_multi_launch is K1 with `fpb` frames per block (the frames-per-
//   program probe of tools/exp_window_crop.py, crop_batch_pallas_multi):
//   each thread crops one pixel position in fpb consecutive frames.
//
// Bound on an H100 SXM (3.35 TB/s): the crop moves B*S*S*3*out_bytes
// written plus, for each frame, the bbox window its taps touch (rows x cols
// x 3 bytes) read; at B = 64 and f32 the writes alone are 38.5 MB, about
// 11.5 us. The kernel does ~20 flops per output value, far below the
// compute roof, so it is bound by bytes. Design: one thread per output
// pixel, all three channels per thread, NHWC written directly (no
// transposes), launched on the caller's stream. Staging the bbox window in
// shared memory and vectorised stores are left for later work.

#include "resample_common.cuh"

namespace {

template <typename OutT>
__global__ void crop_kernel(const uint8_t* __restrict__ frames,
                            const float* __restrict__ bboxes,
                            OutT* __restrict__ out, int H, int W, int S,
                            float scale) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= S * S) return;
  const int oy = pix / S;
  const int ox = pix - oy * S;
  resample::crop_pixel(frames + (int64_t)b * H * W * 3, bboxes + 4 * b, H, W, S, scale,
                       oy, ox, out + (((int64_t)b * S + oy) * S + ox) * 3);
}

// The window's first column, a multiple of 128: the chunk below the box's
// scaled left edge, xblk = clip(floor((cx - w * scale/2 - 1) / 128), 0,
// n_chunks - n_win), in the f32 order of ops/crop.window_blocks (the
// division by 128 is exact).
__device__ __forceinline__ int window_lo(const float* bbox, float scale, int W, int window) {
  const float xs_min = __fsub_rn(bbox[0], __fmul_rn(bbox[2], __fmul_rn(scale, 0.5f)));
  const int blk = (int)floorf(__fmul_rn(__fsub_rn(xs_min, 1.0f), 1.0f / 128.0f));
  const int max_blk = (W + 127) / 128 - window / 128;
  return min(max(blk, 0), max_blk) * 128;
}

template <typename OutT>
__global__ void crop_window_kernel(const uint8_t* __restrict__ frames,
                                   const float* __restrict__ bboxes, OutT* __restrict__ out,
                                   int H, int W, int S, float scale, int window) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= S * S) return;
  const int oy = pix / S;
  const int ox = pix - oy * S;
  const int lo = window_lo(bboxes + 4 * b, scale, W, window);
  resample::crop_pixel<OutT, true>(frames + (int64_t)b * H * W * 3, bboxes + 4 * b, H, W, S,
                                   scale, oy, ox, out + (((int64_t)b * S + oy) * S + ox) * 3,
                                   lo, lo + window);
}

template <typename OutT>
__global__ void crop_multi_kernel(const uint8_t* __restrict__ frames,
                                  const float* __restrict__ bboxes, OutT* __restrict__ out,
                                  int H, int W, int S, float scale, int fpb) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= S * S) return;
  const int oy = pix / S;
  const int ox = pix - oy * S;
  for (int f = 0; f < fpb; ++f) {
    const int b = blockIdx.y * fpb + f;
    resample::crop_pixel(frames + (int64_t)b * H * W * 3, bboxes + 4 * b, H, W, S, scale, oy,
                         ox, out + (((int64_t)b * S + oy) * S + ox) * 3);
  }
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing, and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int crop_batch_launch(const void* frames, const void* bboxes,
                                 void* out, int B, int H, int W, int S,
                                 float scale, int out_bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int threads = 256;
  const dim3 grid((S * S + threads - 1) / threads, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* bb = static_cast<const float*>(bboxes);
  if (out_bf16) {
    crop_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        f, bb, static_cast<__nv_bfloat16*>(out), H, W, S, scale);
  } else {
    crop_kernel<float><<<grid, threads, 0, st>>>(
        f, bb, static_cast<float*>(out), H, W, S, scale);
  }
  return (int)cudaGetLastError();
}

// K3: window in pixels, a multiple of 128 narrower than the frame's
// 128-column chunks; each frame's window start comes from its box.
extern "C" int crop_window_launch(const void* frames, const void* bboxes, void* out, int B,
                                  int H, int W, int S, float scale, int window, int out_bf16,
                                  void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (window <= 0 || window % 128 || window / 128 >= (W + 127) / 128)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((S * S + threads - 1) / threads, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* bb = static_cast<const float*>(bboxes);
  if (out_bf16) {
    crop_window_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        f, bb, static_cast<__nv_bfloat16*>(out), H, W, S, scale, window);
  } else {
    crop_window_kernel<float><<<grid, threads, 0, st>>>(
        f, bb, static_cast<float*>(out), H, W, S, scale, window);
  }
  return (int)cudaGetLastError();
}

// K1 with fpb frames per block; B must be a multiple of fpb.
extern "C" int crop_multi_launch(const void* frames, const void* bboxes, void* out, int B,
                                 int H, int W, int S, float scale, int fpb, int out_bf16,
                                 void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (fpb <= 0 || B % fpb) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((S * S + threads - 1) / threads, B / fpb);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* bb = static_cast<const float*>(bboxes);
  if (out_bf16) {
    crop_multi_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        f, bb, static_cast<__nv_bfloat16*>(out), H, W, S, scale, fpb);
  } else {
    crop_multi_kernel<float><<<grid, threads, 0, st>>>(
        f, bb, static_cast<float*>(out), H, W, S, scale, fpb);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* crop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
