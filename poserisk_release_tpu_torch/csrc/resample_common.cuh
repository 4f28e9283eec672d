// Device helpers shared by the crop kernels (crop.cu: K1 and the windowed
// K3) and the fused letterbox + crop kernel (letterbox_crop.cu, K2): the bbox crop's sample
// position and taps, one crop output pixel, and the f32 / bf16 stores.
//
// Crop semantics (the plain version is ops/crop.py:crop_batch_plain):
//   step  = (size_px * scale) / S             per axis, from bbox [cx, cy, w, h]
//   coord = (dst - S/2) * step + centre
//   i0 = floor(coord), frac = coord - i0, i1 = i0 + 1
//   w0 = (0 <= i0 < size) * (1 - frac), w1 = (0 <= i1 < size) * frac
//   out = (wy0 (wx0 p00 + wx1 p01) + wy1 (wx0 p10 + wx1 p11)) * (1/255)
// Taps outside the frame carry weight 0 (zero border); their indices are
// clamped before the read. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction), in the plain version's order,
// so the f32 output equals the plain version's bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace resample {

struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps crop_axis_taps(float coord, int size) {
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

// The 2x2 bilinear sum of one channel, before any scaling:
// wy0 (wx0 p00 + wx1 p01) + wy1 (wx0 p10 + wx1 p11).
__device__ __forceinline__ float bilinear(const uint8_t* frame, int W, const Taps& ty,
                                          const Taps& tx, int c) {
  const uint8_t* r0p = frame + (int64_t)ty.i0 * W * 3;
  const uint8_t* r1p = frame + (int64_t)ty.i1 * W * 3;
  const float r0 = __fadd_rn(__fmul_rn(tx.w0, (float)r0p[tx.i0 * 3 + c]),
                             __fmul_rn(tx.w1, (float)r0p[tx.i1 * 3 + c]));
  const float r1 = __fadd_rn(__fmul_rn(tx.w0, (float)r1p[tx.i0 * 3 + c]),
                             __fmul_rn(tx.w1, (float)r1p[tx.i1 * 3 + c]));
  return __fadd_rn(__fmul_rn(ty.w0, r0), __fmul_rn(ty.w1, r1));
}

// One crop output pixel (oy, ox) of an S x S crop, all three channels,
// written NHWC at out[0..2]. kWindow (the windowed crop, K3) drops a column
// tap whose (clamped) source column lies outside [win_lo, win_hi): the read
// window of the TPU kernel crop_batch_pallas_windowed.
template <typename OutT, bool kWindow = false>
__device__ __forceinline__ void crop_pixel(const uint8_t* frame, const float* bbox, int H,
                                           int W, int S, float scale, int oy, int ox,
                                           OutT* out, int win_lo = 0, int win_hi = 0) {
  const float half = 0.5f * (float)S;
  const float step_x = __fdiv_rn(__fmul_rn(bbox[2], scale), (float)S);
  const float step_y = __fdiv_rn(__fmul_rn(bbox[3], scale), (float)S);
  const float xs = __fadd_rn(__fmul_rn(__fsub_rn((float)ox, half), step_x), bbox[0]);
  const float ys = __fadd_rn(__fmul_rn(__fsub_rn((float)oy, half), step_y), bbox[1]);
  const Taps ty = crop_axis_taps(ys, H);
  Taps tx = crop_axis_taps(xs, W);
  if (kWindow) {
    if (tx.i0 < win_lo || tx.i0 >= win_hi) tx.w0 = 0.0f;
    if (tx.i1 < win_lo || tx.i1 >= win_hi) tx.w1 = 0.0f;
  }
  const float inv255 = 1.0f / 255.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    store(out, c, __fmul_rn(bilinear(frame, W, ty, tx, c), inv255));
  }
}

}  // namespace resample
