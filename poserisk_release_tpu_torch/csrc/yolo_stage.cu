// Kernel K5: one int8 Darknet-53 residual stage, two launches per block.
//
// Replaces the TPU kernel fused_residual_stage
// (poserisk_release_tpu/ops/yolo_stage_pallas.py:147, body _stage_kernel at
// :107). Each residual block j of the stage computes, on the f32 stream h
// (B*H*W rows of C channels):
//   q  = clip(rint(h * inv1), +-127)             (s8)
//   a  = leaky(d1 * (q x qk1) + b1)              1x1: K = C, N = C/2
//   aq = clip(rint(a * inv3), +-127)             (s8, written to `aq`)
//   y  = leaky(d3 * conv3x3(aq, qk3) + b3)       3x3: K = 9*C/2, N = C
//   h  = h + y
// The plain version is ops/yolo_stage.fused_residual_stage_plain.
//
// What does not carry over from the TPU: the Pallas kernel keeps one
// frame's f32 stream in VMEM across the stage's blocks (1.9 MB at
// 36x52x256). An SM has 227 KB of shared memory and blocks run in parallel
// in no order, so nothing is carried between them here: the stream stays
// in device memory (mostly in the 50 MB L2 at small batches) and each
// residual block is two launches, (a) the 1x1 product with the stream's
// quantization fused into its loads and the second quantization into its
// epilogue, writing `aq` as int8, and (b) the 3x3 conv as an implicit GEMM
// over K = 9*C/2 whose zero padding is a load mask, with the shortcut add
// fused into its epilogue (in place on the f32 stream; the first block reads
// the input dtype and the last writes it).
//
// Bound on an H100 SXM: each block is 10*H*W*C^2 int8 operations (1.23 G
// per frame at every stage shape of the rect canvas), against 1,979 TOPS of
// dense int8; the bytes (stream in and out, weights) take far less at
// 3.35 TB/s, so the stage is bound by operations. Design: the integer
// products are the kernel's own mma.sync.m16n8k32 s8 -> s32 tensor-core
// instructions, on 64x64 output tiles per 128-thread block (four warps of
// 32x32), 64-deep K tiles staged in shared memory at an 80-byte row pitch
// (conflict-free fragment loads). wgmma, TMA, a cp.async pipeline and
// keeping the stream on chip are later work.
//
// Rounding, so that the card equals the plain version bit for bit: every
// product and sum is rounded on its own (__int2float_rn, __fmul_rn,
// __fadd_rn, in the TPU kernel's order, no FMA contraction), rintf for
// round-half-to-even, and leaky as y > 0 ? y : 0.1f * y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // BM = BN = BK
constexpr int kPitch = 80;  // shared row pitch in bytes

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quant(float x, float inv_s) {
  float q = rintf(__fmul_rn(x, inv_s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float leaky(float y) { return y > 0.0f ? y : __fmul_rn(0.1f, y); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 64x64x64 tile product from shared memory: warp (wm, wn) owns rows
// wm*32..+31 and columns wn*32..+31 of the block's output tile.
__device__ __forceinline__ void tile_mma(const int8_t* As, const int8_t* Bs, int (&acc)[2][4][4],
                                         int wm, int wn, int g, int tig) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = As + (wm * 32 + mi * 16 + g) * kPitch + ks * 32 + tig * 4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = Bs + (wn * 32 + ni * 8 + g) * kPitch + ks * 32 + tig * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

// Stage rows n0..n0+63, columns k0..k0+63 of a K-contiguous int8 weight
// matrix (ld bytes per row) into shared memory: two 16-byte chunks a thread.
__device__ __forceinline__ void load_weights(int8_t* Bs, const int8_t* w, int64_t ld, int n0,
                                             int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 2, part = c & 3;
    *reinterpret_cast<int4*>(Bs + row * kPitch + part * 16) =
        *reinterpret_cast<const int4*>(w + (int64_t)(n0 + row) * ld + k0 + part * 16);
  }
}

// (a) The 1x1 conv: aq = quant(leaky(d1 * (quant(h, inv1) x qk1) + b1), inv3).
template <typename InT>
__global__ void __launch_bounds__(kThreads)
stage_1x1_kernel(const InT* __restrict__ h, int8_t* __restrict__ aq,
                 const int8_t* __restrict__ w1t, const float* __restrict__ d1,
                 const float* __restrict__ b1, float inv1, float inv3, int M, int C) {
  __shared__ __align__(16) int8_t As[kTile * kPitch];
  __shared__ __align__(16) int8_t Bs[kTile * kPitch];
  const int half = C >> 1;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tig = lane & 3;
  int acc[2][4][4] = {};

  // A loads: thread t quantizes 32 consecutive channels of row t/2.
  const int arow = threadIdx.x >> 1, acol = (threadIdx.x & 1) * 32;
  const int64_t m = m0 + arow;
  for (int k0 = 0; k0 < C; k0 += kTile) {
    alignas(16) int8_t q[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      q[i] = m < M ? quant(load_f(h, m * C + k0 + acol + i), inv1) : (int8_t)0;
    *reinterpret_cast<int4*>(As + arow * kPitch + acol) = *reinterpret_cast<const int4*>(q);
    *reinterpret_cast<int4*>(As + arow * kPitch + acol + 16) =
        *reinterpret_cast<const int4*>(q + 16);
    load_weights(Bs, w1t, C, n0, k0);
    __syncthreads();
    tile_mma(As, Bs, acc, wm, wn, g, tig);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row >= M) continue;
        const float y =
            leaky(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), d1[col]), b1[col]));
        aq[row * half + col] = quant(y, inv3);
      }
}

// (b) The 3x3 conv on aq (zero padding as a load mask) and the shortcut:
// out = h + leaky(d3 * conv3x3(aq, qk3) + b3). h and out may alias.
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
stage_3x3_kernel(const InT* h, OutT* out, const int8_t* __restrict__ aq,
                 const int8_t* __restrict__ w3t, const float* __restrict__ d3,
                 const float* __restrict__ b3, int M, int H, int W, int C) {
  __shared__ __align__(16) int8_t As[kTile * kPitch];
  __shared__ __align__(16) int8_t Bs[kTile * kPitch];
  const int half = C >> 1, K = 9 * half;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tig = lane & 3;
  int acc[2][4][4] = {};

  // Each thread stages two 16-byte chunks of the A tile: (row, part).
  int rows[2], parts[2], py[2], px[2], pb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    rows[i] = c >> 2;
    parts[i] = c & 3;
    const int m = m0 + rows[i];
    pb[i] = m < M ? m / (H * W) : -1;
    const int r = m - (m / (H * W)) * (H * W);
    py[i] = r / W;
    px[i] = r - py[i] * W;
  }
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int tap = k0 / half, c0 = k0 - tap * half;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = py[i] + dy, xx = px[i] + dx;
      int4 v = make_int4(0, 0, 0, 0);
      if (pb[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = *reinterpret_cast<const int4*>(
            aq + (((int64_t)pb[i] * H + yy) * W + xx) * half + c0 + parts[i] * 16);
      *reinterpret_cast<int4*>(As + rows[i] * kPitch + parts[i] * 16) = v;
    }
    load_weights(Bs, w3t, K, n0, k0);
    __syncthreads();
    tile_mma(As, Bs, acc, wm, wn, g, tig);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row >= M) continue;
        const float y =
            leaky(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), d3[col]), b3[col]));
        const int64_t i = row * C + col;
        store_f(out, i, __fadd_rn(load_f(h, i), y));
      }
}

template <typename InT, typename OutT>
int launch_block(const void* h_in, void* h_out, int8_t* aq, const int8_t* w1t,
                 const float* d1, const float* b1, const float* d3, const float* b3,
                 const int8_t* w3t, float inv1, float inv3, int B, int H, int W, int C,
                 cudaStream_t st) {
  const int M = B * H * W;
  const dim3 grid_a((M + kTile - 1) / kTile, (C / 2) / kTile);
  stage_1x1_kernel<InT><<<grid_a, kThreads, 0, st>>>(static_cast<const InT*>(h_in), aq, w1t,
                                                     d1, b1, inv1, inv3, M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((M + kTile - 1) / kTile, C / kTile);
  stage_3x3_kernel<InT, OutT><<<grid_b, kThreads, 0, st>>>(
      static_cast<const InT*>(h_in), static_cast<OutT*>(h_out), aq, w3t, d3, b3, M, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: one residual block (both launches) on
// `stream`, h_in -> h_out (f32 or bf16 each; they may be the same f32
// buffer). C must be a multiple of 128. Does not synchronise, allocates
// nothing, returns the cudaGetLastError() code (0 on success).
extern "C" int yolo_stage_block_launch(const void* h_in, int in_bf16, void* h_out,
                                       int out_bf16, void* aq, const void* w1t, const void* d1,
                                       const void* b1, const void* d3, const void* b3,
                                       const void* w3t, float inv1, float inv3, int B, int H,
                                       int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(aq);
  const int8_t* k1 = static_cast<const int8_t*>(w1t);
  const int8_t* k3 = static_cast<const int8_t*>(w3t);
  const float *pd1 = static_cast<const float*>(d1), *pb1 = static_cast<const float*>(b1);
  const float *pd3 = static_cast<const float*>(d3), *pb3 = static_cast<const float*>(b3);
  if (in_bf16 && out_bf16)
    return launch_block<__nv_bfloat16, __nv_bfloat16>(h_in, h_out, q, k1, pd1, pb1, pd3, pb3,
                                                      k3, inv1, inv3, B, H, W, C, st);
  if (in_bf16)
    return launch_block<__nv_bfloat16, float>(h_in, h_out, q, k1, pd1, pb1, pd3, pb3, k3,
                                              inv1, inv3, B, H, W, C, st);
  if (out_bf16)
    return launch_block<float, __nv_bfloat16>(h_in, h_out, q, k1, pd1, pb1, pd3, pb3, k3,
                                              inv1, inv3, B, H, W, C, st);
  return launch_block<float, float>(h_in, h_out, q, k1, pd1, pb1, pd3, pb3, k3, inv1, inv3,
                                    B, H, W, C, st);
}

extern "C" const char* yolo_stage_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
