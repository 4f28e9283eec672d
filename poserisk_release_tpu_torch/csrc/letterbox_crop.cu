// Fused detector letterbox + bbox crop: one launch reads each raw uint8
// frame and writes the detector's letterbox canvas and the pose path's
// 224x224 crop, both NHWC, f32 or bf16, in [0, 1].
//
// Replaces the TPU kernel fused_letterbox_crop
// (poserisk_release_tpu/ops/resample_pallas.py:133, body _kernel at :97).
// The TPU kernel DMAs one whole frame into VMEM and runs two pairs of
// tap-matrix matmuls on it, because a TPU has no hardware gather. Hopper
// gathers, so here each output pixel reads its 2x2 source taps itself: one
// thread per output pixel, all three channels, NHWC written directly.
//
// Letterbox (the plain version is ops/crop.py:letterbox_plain): the taps of
// each canvas row and column are static per frame geometry and come from
// host tables (i0, i1, w0, w1 per index; ops/crop.letterbox_axis_taps, cv2's
// half-pixel rule, zero weights outside the content band). Per pixel
//   v      = (wy0 (wx0 p00 + wx1 p01) + wy1 (wx0 p10 + wx1 p11)) * (1/255)
//   border = 128/255 * (1 - (wy0 + wy1) * (wx0 + wx1))
//   out    = v + border
// Where the source index clamps (i1 = i0 at the last row or column) both
// weights fall on the same pixel. The crop is K1's (resample_common.cuh).
// Every product and sum is rounded on its own in the plain version's order,
// so the f32 outputs equal the plain version's bit for bit; bf16 outputs
// are the f32 value rounded to nearest even.
//
// Strides: the kernel walks the sub-frames frames[::frame_stride]; sub-frame
// b writes letterbox b / det_stride when b % det_stride == 0 and crop
// b / crop_stride when b % crop_stride == 0 (crop_stride 0: letterbox-only
// mode). The grid covers only the sub-frames with output: a host-built work
// table lists them (sub-frame index, first block), and a block finds its
// sub-frame by binary search. Skipped frames launch no threads.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At 64 frames of 450x800, strides
// 1/1 and f32 it moves 69.1 MB of frames read (the letterbox touches every
// pixel), 92.0 MB of letterbox and 38.5 MB of crops written: 199.7 MB,
// about 60 us; the ~20 flops per output value are far below the compute
// roof. A 1.08 MB frame does not fit the 228 KB of shared memory of an SM,
// so "one read of each frame" comes from L2 (50 MB): blocks are ordered
// frame-major, a frame's letterbox blocks and then its crop blocks, so the
// blocks that read one frame run together while it is resident in L2.
// Staging rows in shared memory and vectorised stores are left for later.

#include "resample_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ resample::Taps table_taps(const int4* table, int o) {
  const int4 t = table[o];
  resample::Taps r;
  r.i0 = t.x;
  r.i1 = t.y;
  r.w0 = __int_as_float(t.z);
  r.w1 = __int_as_float(t.w);
  return r;
}

template <typename OutT>
__global__ void letterbox_crop_kernel(
    const uint8_t* __restrict__ frames, int64_t frame_step, int H, int W,
    const int* __restrict__ work, int n_active,
    const int4* __restrict__ rows, const int4* __restrict__ cols, int CH, int CW,
    OutT* __restrict__ letter, int det_stride, int lb_blocks,
    const float* __restrict__ bboxes, int64_t bbox_step, OutT* __restrict__ crops,
    int S, float scale, int crop_stride) {
  // work[0 .. n_active): sub-frame index of each active sub-frame;
  // work[n_active .. 2 n_active]: its first block (prefix sums).
  const int* first = work + n_active;
  const int blk = blockIdx.x;
  int lo = 0, hi = n_active - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int sub = work[lo];
  int local = blk - first[lo];
  const uint8_t* frame = frames + (int64_t)sub * frame_step;

  if (sub % det_stride == 0) {
    if (local < lb_blocks) {
      const int pix = local * kThreads + threadIdx.x;
      if (pix >= CH * CW) return;
      const int oy = pix / CW;
      const int ox = pix - oy * CW;
      const resample::Taps ty = table_taps(rows, oy);
      const resample::Taps tx = table_taps(cols, ox);
      const float inv255 = 1.0f / 255.0f;
      const float gray = (float)(128.0 / 255.0);
      const float coverage = __fmul_rn(__fadd_rn(ty.w0, ty.w1), __fadd_rn(tx.w0, tx.w1));
      const float border = __fmul_rn(gray, __fsub_rn(1.0f, coverage));
      OutT* out = letter + (((int64_t)(sub / det_stride) * CH + oy) * CW + ox) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = __fmul_rn(resample::bilinear(frame, W, ty, tx, c), inv255);
        resample::store(out, c, __fadd_rn(v, border));
      }
      return;
    }
    local -= lb_blocks;
  }
  // The remaining blocks of an active sub-frame are its crop blocks.
  const int pix = local * kThreads + threadIdx.x;
  if (pix >= S * S) return;
  const int oy = pix / S;
  const int ox = pix - oy * S;
  resample::crop_pixel(frame, bboxes + (int64_t)sub * bbox_step, H, W, S, scale, oy, ox,
                       crops + (((int64_t)(sub / crop_stride) * S + oy) * S + ox) * 3);
}

}  // namespace

// Plain C interface for ctypes. frame_step / bbox_step are the element
// distances between consecutive sub-frames (frame_stride times the batch
// stride). crop_stride 0 is the letterbox-only mode (bboxes and crops
// unused). Launches on `stream`, does not synchronise, allocates nothing,
// and returns the cudaGetLastError() code of the launch (0 on success).
extern "C" int letterbox_crop_launch(
    const void* frames, long long frame_step, int H, int W,
    const void* work, int n_active, int total_blocks,
    const void* rows, const void* cols, int CH, int CW, void* letter, int det_stride,
    const void* bboxes, long long bbox_step, void* crops, int S, float scale,
    int crop_stride, int out_bf16, void* stream) {
  if (n_active <= 0 || total_blocks <= 0) return 0;
  const int lb_blocks = (CH * CW + kThreads - 1) / kThreads;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const int* w = static_cast<const int*>(work);
  const int4* r = static_cast<const int4*>(rows);
  const int4* c = static_cast<const int4*>(cols);
  const float* bb = static_cast<const float*>(bboxes);
  if (out_bf16) {
    letterbox_crop_kernel<__nv_bfloat16><<<total_blocks, kThreads, 0, st>>>(
        f, frame_step, H, W, w, n_active, r, c, CH, CW,
        static_cast<__nv_bfloat16*>(letter), det_stride, lb_blocks, bb, bbox_step,
        static_cast<__nv_bfloat16*>(crops), S, scale, crop_stride);
  } else {
    letterbox_crop_kernel<float><<<total_blocks, kThreads, 0, st>>>(
        f, frame_step, H, W, w, n_active, r, c, CH, CW, static_cast<float*>(letter),
        det_stride, lb_blocks, bb, bbox_step, static_cast<float*>(crops), S, scale,
        crop_stride);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* letterbox_crop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
