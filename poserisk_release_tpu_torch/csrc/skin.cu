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
// Design: a block owns a slice of 8 consecutive vertices. It copies the
// slice's rows of all four tables (21 KB, contiguous in each table) into
// shared memory with 16-byte cp.async at once, the unaligned ends of a
// region by 4-byte loads, so the whole table is in flight from the start:
// 862 blocks at V = 6890, one wave. At B = 1 the bytes in flight, not the
// arithmetic, set the time; a previous version read the tables with one
// 128-byte load in flight a warp and was latency-bound (PERF.md, K4). The
// block then walks the frames in tiles of kFrames (1 when B = 1, so no
// register or FMA goes to frames that do not exist; else 8), copying each
// tile's betas, pose features and joint affines (at a padded stride, so
// the blend's reads are conflict-free) the same way while the slice stays
// in shared memory: the tables are read once for every B. A warp takes a
// vertex: its lanes split the vertex's three 217-float blend rows
// (conflict-free shared reads) and accumulate every frame of the tile from
// each loaded value; a halving reduction (reduce_to_frame) leaves lane
// (f, c) with the posed position in frame f, and the lane blends row c of
// the vertex's 3x4 transform over the 24 joints and writes out_c.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps per block, one vertex each at a time
constexpr unsigned kFull = 0xffffffffu;

// Floats of shared memory a region of n floats takes: 16 bytes of slack in
// front, so the copy can keep the source's alignment mod 16.
__host__ __device__ constexpr int region(int n) { return (n + 4 + 3) & ~3; }

__host__ __device__ constexpr int aff_stride(int J) { return 12 * J + 4; }

// Vertices per block: 862 blocks at V = 6890, one wave (16 vertices were
// level at B = 64 and 2% slower at B = 1).
constexpr int kSlice = 8;

__host__ __device__ constexpr int smem_floats(int frames, int NB, int P, int J) {
  return region(kSlice * 3 * P) + region(kSlice * 3 * NB) + region(kSlice * J) +
         region(kSlice * 3) + region(frames * P) + region(frames * NB) +
         region(frames * aff_stride(J));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Starts the copy of src[0, n) into the region at dst (16-byte aligned):
// the floats land at dst + (src's float offset mod 4), which is returned.
// The aligned interior goes in 16-byte cp.async copies, the ragged ends
// by plain loads.
__device__ __forceinline__ float* stage(float* dst, const float* __restrict__ src, int n) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* out = dst + mis;
  const int head = min((4 - mis) & 3, n);
  const int chunks = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) out[i] = __ldg(src + i);
  for (int i = head + 4 * chunks + threadIdx.x; i < n; i += blockDim.x) out[i] = __ldg(src + i);
  for (int j = threadIdx.x; j < chunks; j += blockDim.x)
    cp_async16(out + head + 4 * j, src + head + 4 * j);
  return out;
}

// One step of reduce_to_frame: lanes that differ in bit kBit exchange the
// half of their 2 kHalf values the partner keeps, and each adds what it
// receives to the half it keeps, now in v[0..kHalf).
template <int kHalf, int kBit>
__device__ __forceinline__ void halve(float (&v)[24], int lane) {
  const bool upper = lane & kBit;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float send = upper ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(kFull, send, kBit);
  }
}

// Sums v[0..24) (v[3 f + c]: frame f, coordinate c of an 8-frame tile)
// over the warp's lanes, leaving lane l with the three sums of frame
// l / 4 in v[0..3): lane bits 4, 3, 2 pick frame bits 2, 1, 0, so
// 12 + 6 + 3 + 6 shuffles instead of a butterfly's 120.
__device__ __forceinline__ void reduce_to_frame(float (&v)[24], int lane) {
  halve<12, 16>(v, lane);
  halve<6, 8>(v, lane);
  halve<3, 4>(v, lane);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] += __shfl_xor_sync(kFull, v[c], 2);
    v[c] += __shfl_xor_sync(kFull, v[c], 1);
  }
}

template <int kFrames>
__global__ void __launch_bounds__(kWarps * 32) skin_kernel(
    const float* __restrict__ betas, const float* __restrict__ pose_map,
    const float* __restrict__ affines, const float* __restrict__ v_template,
    const float* __restrict__ shapedirs, const float* __restrict__ posedirs,
    const float* __restrict__ weights, float* __restrict__ out, int B, int V, int NB, int P,
    int J) {
  static_assert(kFrames == 1 || kFrames == 8, "frame tiles of 1 or 8");
  extern __shared__ __align__(16) float smem[];
  const int v0 = blockIdx.x * kSlice;
  const int nv = min(kSlice, V - v0);
  const int stride = aff_stride(J);
  // (1) The slice's table rows, all in flight at once.
  float* region_pd = smem;
  float* region_sd = region_pd + region(kSlice * 3 * P);
  float* region_w = region_sd + region(kSlice * 3 * NB);
  float* region_t = region_w + region(kSlice * J);
  float* region_pose = region_t + region(kSlice * 3);
  float* region_beta = region_pose + region(kFrames * P);
  float* region_aff = region_beta + region(kFrames * NB);
  const float* s_pd = stage(region_pd, posedirs + (int64_t)v0 * 3 * P, nv * 3 * P);
  const float* s_sd = stage(region_sd, shapedirs + (int64_t)v0 * 3 * NB, nv * 3 * NB);
  const float* s_w = stage(region_w, weights + (int64_t)v0 * J, nv * J);
  const float* s_t = stage(region_t, v_template + (int64_t)v0 * 3, nv * 3);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int f0 = 0; f0 < B; f0 += kFrames) {
    const int nf = min(kFrames, B - f0);
    // (2) The tile's per-frame inputs, by the same async copies (the
    // affines at a padded stride; a frame's 12 J floats keep the alignment
    // mod 16 of the first). Frames past the batch's end hold stale values
    // and are never written.
    if (f0 > 0) __syncthreads();  // the previous tile is done with them
    const float* s_pose = stage(region_pose, pose_map + (int64_t)f0 * P, nf * P);
    const float* s_beta = stage(region_beta, betas + (int64_t)f0 * NB, nf * NB);
    const float* s_aff = region_aff;
    for (int f = 0; f < nf; ++f)
      s_aff = stage(region_aff + f * stride, affines + (int64_t)(f0 + f) * J * 12, J * 12) -
              f * stride;
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // (3) A warp per vertex: the posed position in every frame of the tile.
    for (int vl = warp; vl < nv; vl += kWarps) {
      float acc[3 * kFrames];
#pragma unroll
      for (int i = 0; i < 3 * kFrames; ++i) acc[i] = 0.0f;
      const float* sd = s_sd + vl * 3 * NB;
      const float* pd = s_pd + vl * 3 * P;
      for (int s = lane; s < NB; s += 32) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d = sd[c * NB + s];
#pragma unroll
          for (int f = 0; f < kFrames; ++f)
            acc[3 * f + c] = fmaf(d, s_beta[f * NB + s], acc[3 * f + c]);
        }
      }
      for (int k = lane; k < P; k += 32) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d = pd[c * P + k];
#pragma unroll
          for (int f = 0; f < kFrames; ++f)
            acc[3 * f + c] = fmaf(d, s_pose[f * P + k], acc[3 * f + c]);
        }
      }
      // Lane (f, c): row c of the blended 3x4 transform, applied in frame f.
      int f, c;
      if constexpr (kFrames == 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
        f = 0;
        c = lane;
      } else {
        reduce_to_frame(acc, lane);
        f = lane >> 2;
        c = lane & 3;
      }
      if (c < 3 && f < nf) {
        const float x = s_t[vl * 3] + acc[0];
        const float y = s_t[vl * 3 + 1] + acc[1];
        const float z = s_t[vl * 3 + 2] + acc[2];
        const float* w = s_w + vl * J;
        const float* a = s_aff + f * stride;
        float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
        for (int j = 0; j < J; ++j) {
          const float wj = w[j];
          const float* aj = a + j * 12;
          m0 = fmaf(wj, aj[3 * c], m0);
          m1 = fmaf(wj, aj[3 * c + 1], m1);
          m2 = fmaf(wj, aj[3 * c + 2], m2);
          m3 = fmaf(wj, aj[9 + c], m3);
        }
        out[((int64_t)(f0 + f) * V + v0 + vl) * 3 + c] = m0 * x + m1 * y + m2 * z + m3;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Launches on `stream`, does not synchronise,
// allocates nothing, and returns the cudaGetLastError() code of the launch
// (0 on success). Every pointer is a contiguous f32 array.
extern "C" int skin_vertices_launch(const void* betas, const void* pose_map, const void* affines,
                                    const void* v_template, const void* shapedirs,
                                    const void* posedirs, const void* weights, void* out, int B,
                                    int V, int NB, int P, int J, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const int frames = B == 1 ? 1 : 8;
  const size_t smem = (size_t)smem_floats(frames, NB, P, J) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // 38 KB for SMPL's tables
  const dim3 grid((V + kSlice - 1) / kSlice);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* args[7] = {static_cast<const float*>(betas), static_cast<const float*>(pose_map),
                          static_cast<const float*>(affines),
                          static_cast<const float*>(v_template),
                          static_cast<const float*>(shapedirs),
                          static_cast<const float*>(posedirs), static_cast<const float*>(weights)};
  if (frames == 1) {
    skin_kernel<1><<<grid, kWarps * 32, smem, st>>>(args[0], args[1], args[2], args[3], args[4],
                                                    args[5], args[6], static_cast<float*>(out),
                                                    B, V, NB, P, J);
  } else {
    skin_kernel<8><<<grid, kWarps * 32, smem, st>>>(args[0], args[1], args[2], args[3], args[4],
                                                    args[5], args[6], static_cast<float*>(out),
                                                    B, V, NB, P, J);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* skin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
