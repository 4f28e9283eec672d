// SMPL vertex skinning: shape blend + pose correctives + linear blend
// skinning of every vertex of every frame, (B, V, 3) f32 vertices in rest-
// space-removed world coordinates (translation is added outside).
//
// Replaces the TPU kernel skin_vertices_pallas
// (poserisk_release_tpu/ops/lbs_pallas.py:74, body _skin_kernel at :42),
// which streams 512-vertex tiles through VMEM and runs the blends as
// matmuls with the batch on lanes. Per vertex v and frame f:
//   v_c   = v_template[v, c] + sum_s shapedirs[3v+c, s] betas[f, s]
//                            + sum_k posedirs[3v+c, k] pose_map[f, k]
//   M     = sum_j weights[v, j] A[f, j, :]           (12 values: [R | t])
//   out_c = M[3c] v_x + M[3c+1] v_y + M[3c+2] v_z + M[9+c]
// The plain version is ops/skin.py:skin_vertices_plain (the vertex part of
// ops/lbs._lbs_impl); sums are taken in another order than its matmuls, so
// the two agree to f32 rounding (about 1e-7 of the vertex scale).
//
// Bound on an H100 SXM: reading the tables once (posedirs 17.1 MB,
// shapedirs 0.83 MB, weights 0.66 MB, template 0.08 MB) plus writing
// B*V*3*4 bytes, against ~1.9 kFLOP per vertex-frame in f32 off the tensor
// cores (67 TFLOP/s): bytes bound at B = 1 (the debug mesh, ~5.6 us), bound
// by operations at B = 64 (~12.5 us).
//
// Design: a block holds 8 vertices x 8 frames, one warp per vertex. The
// frames' betas, pose_map and joint affines are staged in shared memory
// (the affines at a padded stride, so the blend's reads are conflict-free).
// The lanes of a warp split each of the vertex's three blend rows (217
// contiguous floats: coalesced 128 B loads, conflict-free shared reads),
// accumulate all 8 frames from each loaded value, and a butterfly
// reduction leaves every lane with the posed position in every frame. Then
// lane (f, c) = (lane / 4, lane % 4), c < 3, blends row c of the vertex's
// 3x4 transform for frame f over the 24 joints and writes out_c. A first
// version with one thread per vertex read each row alone, 2.5 KB apart
// across a warp, and was latency-bound at B = 1 (PERF.md, K4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // vertices per block, one warp each
constexpr int kFrames = 8;   // frames per block; 8 frames x 4 = 32 lanes
constexpr unsigned kFull = 0xffffffffu;

__global__ void skin_kernel(const float* __restrict__ betas, const float* __restrict__ pose_map,
                            const float* __restrict__ affines,
                            const float* __restrict__ v_template,
                            const float* __restrict__ shapedirs,
                            const float* __restrict__ posedirs,
                            const float* __restrict__ weights, float* __restrict__ out, int B,
                            int V, int NB, int P, int J) {
  extern __shared__ float smem[];
  // A frame's affines start 12 J + 4 floats after the previous frame's: the
  // 4 extra floats put lane (f, c)'s reads in 4 f + 3 c (mod 32), 24
  // distinct banks, where a 12 J = 288 stride puts all 8 frames on one.
  const int aff_stride = 12 * J + 4;
  float* s_pose = smem;                   // kFrames x P
  float* s_beta = s_pose + kFrames * P;   // kFrames x NB
  float* s_aff = s_beta + kFrames * NB;   // kFrames x aff_stride
  const int f0 = blockIdx.y * kFrames;
  const int nf = min(kFrames, B - f0);
  // Frames past the batch's end are staged as zeros and never written.
  for (int i = threadIdx.x; i < kFrames * P; i += blockDim.x)
    s_pose[i] = i < nf * P ? pose_map[(int64_t)f0 * P + i] : 0.0f;
  for (int i = threadIdx.x; i < kFrames * NB; i += blockDim.x)
    s_beta[i] = i < nf * NB ? betas[(int64_t)f0 * NB + i] : 0.0f;
  for (int i = threadIdx.x; i < nf * J * 12; i += blockDim.x)
    s_aff[(i / (J * 12)) * aff_stride + i % (J * 12)] = affines[(int64_t)f0 * J * 12 + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= V) return;  // whole warps only, after the block's last barrier

  // Posed rest-space position in each frame of the tile, in every lane.
  float pos[kFrames][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* sd = shapedirs + ((int64_t)v * 3 + c) * NB;
    const float* pd = posedirs + ((int64_t)v * 3 + c) * P;
    float acc[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) acc[f] = 0.0f;
    for (int s = lane; s < NB; s += 32) {
      const float d = sd[s];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) acc[f] = fmaf(d, s_beta[f * NB + s], acc[f]);
    }
    for (int k = lane; k < P; k += 32) {
      const float d = pd[k];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) acc[f] = fmaf(d, s_pose[f * P + k], acc[f]);
    }
    const float t = v_template[(int64_t)v * 3 + c];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      float a = acc[f];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
      pos[f][c] = t + a;
    }
  }

  // Lane (f, c): row c of the blended 3x4 transform, applied in frame f.
  const int f = lane >> 2;
  const int c = lane & 3;
  if (c == 3 || f >= nf) return;
  float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
  for (int ff = 0; ff < kFrames; ++ff) {  // static indices keep pos in registers
    if (ff == f) {
      x = pos[ff][0];
      y = pos[ff][1];
      z = pos[ff][2];
    }
  }
  const float* w = weights + (int64_t)v * J;
  const float* a = s_aff + f * aff_stride;
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
  for (int j = 0; j < J; ++j) {
    const float wj = w[j];
    const float* aj = a + j * 12;
    m0 = fmaf(wj, aj[3 * c], m0);
    m1 = fmaf(wj, aj[3 * c + 1], m1);
    m2 = fmaf(wj, aj[3 * c + 2], m2);
    m3 = fmaf(wj, aj[9 + c], m3);
  }
  out[((int64_t)(f0 + f) * V + v) * 3 + c] = m0 * x + m1 * y + m2 * z + m3;
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream`, does not synchronise,
// allocates nothing, and returns the cudaGetLastError() code of the launch
// (0 on success).
extern "C" int skin_vertices_launch(const void* betas, const void* pose_map, const void* affines,
                                    const void* v_template, const void* shapedirs,
                                    const void* posedirs, const void* weights, void* out, int B,
                                    int V, int NB, int P, int J, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const dim3 grid((V + kWarps - 1) / kWarps, (B + kFrames - 1) / kFrames);
  const size_t smem = (size_t)kFrames * (P + NB + 12 * J + 4) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  skin_kernel<<<grid, kWarps * 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(betas), static_cast<const float*>(pose_map),
      static_cast<const float*>(affines), static_cast<const float*>(v_template),
      static_cast<const float*>(shapedirs), static_cast<const float*>(posedirs),
      static_cast<const float*>(weights), static_cast<float*>(out), B, V, NB, P, J);
  return (int)cudaGetLastError();
}

extern "C" const char* skin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
