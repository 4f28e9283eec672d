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
//
// Semantics (the plain version is ops/crop.py:crop_batch_plain):
//   step  = (size_px * scale) / S             per axis, from bbox [cx, cy, w, h]
//   coord = (dst - S/2) * step + centre
//   i0 = floor(coord), frac = coord - i0, i1 = i0 + 1
//   w0 = (0 <= i0 < size) * (1 - frac), w1 = (0 <= i1 < size) * frac
//   out = (wy0 (wx0 p00 + wx1 p01) + wy1 (wx0 p10 + wx1 p11)) * (1/255)
// Taps outside the frame carry weight 0 (zero border); their indices are
// clamped before the read. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), in the plain version's
// order, so the f32 output equals the plain version's bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): the crop moves B*S*S*3*out_bytes
// written plus, for each frame, the bbox window its taps touch (rows x cols
// x 3 bytes) read; at B = 64 and f32 the writes alone are 38.5 MB, about
// 11.5 us. The kernel does ~20 flops per output value, far below the
// compute roof, so it is bound by bytes. Design: one thread per output
// pixel, all three channels per thread, NHWC written directly (no
// transposes), launched on the caller's stream. Staging the bbox window in
// shared memory and vectorised stores are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps axis_taps(float coord, int size) {
  const float f0 = floorf(coord);
  const float frac = __fsub_rn(coord, f0);
  // Clamp before the int conversion so far-away coordinates cannot
  // overflow; [-2, size] keeps the validity of both taps unchanged.
  const int i0 = (int)fminf(fmaxf(f0, -2.0f), (float)size);
  const int i1 = i0 + 1;
  Taps t;
  t.w0 = (i0 >= 0 && i0 <= size - 1) ? __fsub_rn(1.0f, frac) : 0.0f;
  t.w1 = (i1 >= 0 && i1 <= size - 1) ? frac : 0.0f;
  t.i0 = min(max(i0, 0), size - 1);
  t.i1 = min(max(i1, 0), size - 1);
  return t;
}

__device__ __forceinline__ void store(float* out, int64_t i, float v) { out[i] = v; }

__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

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

  const float cx = bboxes[4 * b + 0];
  const float cy = bboxes[4 * b + 1];
  const float bw = bboxes[4 * b + 2];
  const float bh = bboxes[4 * b + 3];
  const float half = 0.5f * (float)S;
  const float step_x = __fdiv_rn(__fmul_rn(bw, scale), (float)S);
  const float step_y = __fdiv_rn(__fmul_rn(bh, scale), (float)S);
  const float xs = __fadd_rn(__fmul_rn(__fsub_rn((float)ox, half), step_x), cx);
  const float ys = __fadd_rn(__fmul_rn(__fsub_rn((float)oy, half), step_y), cy);

  const Taps ty = axis_taps(ys, H);
  const Taps tx = axis_taps(xs, W);

  const uint8_t* frame = frames + (int64_t)b * H * W * 3;
  const uint8_t* p00 = frame + ((int64_t)ty.i0 * W + tx.i0) * 3;
  const uint8_t* p01 = frame + ((int64_t)ty.i0 * W + tx.i1) * 3;
  const uint8_t* p10 = frame + ((int64_t)ty.i1 * W + tx.i0) * 3;
  const uint8_t* p11 = frame + ((int64_t)ty.i1 * W + tx.i1) * 3;
  const float inv255 = 1.0f / 255.0f;
  const int64_t o = (((int64_t)b * S + oy) * S + ox) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r0 = __fadd_rn(__fmul_rn(tx.w0, (float)p00[c]),
                               __fmul_rn(tx.w1, (float)p01[c]));
    const float r1 = __fadd_rn(__fmul_rn(tx.w0, (float)p10[c]),
                               __fmul_rn(tx.w1, (float)p11[c]));
    const float v = __fadd_rn(__fmul_rn(ty.w0, r0), __fmul_rn(ty.w1, r1));
    store(out, o + c, __fmul_rn(v, inv255));
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

extern "C" const char* crop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
