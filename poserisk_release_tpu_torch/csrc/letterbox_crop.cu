// Fused detector letterbox + bbox crop: one launch reads each raw uint8
// frame and writes the detector's letterbox canvas and the pose path's
// 224x224 crop, both NHWC, f32 or bf16, in [0, 1].
//
// Replaces the TPU kernel fused_letterbox_crop
// (poserisk_release_tpu/ops/resample_pallas.py:133, body _kernel at :97).
// The TPU kernel DMAs one whole frame into VMEM and runs two pairs of
// tap-matrix matmuls on it, because a TPU has no hardware gather. A frame
// (1.08 MB at 450x800) does not fit an SM's shared memory, so here a block
// stages only the source rows one band of output rows reads.
//
// Letterbox (the plain version is ops/crop.py:letterbox_plain): the taps of
// each canvas row and column are static per frame geometry and come from
// host tables (i0, i1, w0, w1 per index; ops/crop.letterbox_axis_taps, cv2's
// half-pixel rule, zero weights outside the content band). Per pixel
//   v      = (wy0 (wx0 p00 + wx1 p01) + wy1 (wx0 p10 + wx1 p11)) * (1/255)
//   border = 128/255 * (1 - (wy0 + wy1) * (wx0 + wx1))
//   out    = v + border
// Where the source index clamps (i1 = i0 at the last row or column) both
// weights fall on the same pixel. The crop's taps are K1's
// (resample_common.cuh), computed here per row and column. Every product and
// sum is rounded on its own in the plain version's order, so the f32
// outputs equal the plain version's bit for bit; bf16 outputs are the f32
// value rounded to nearest even. A row whose two weights are 0 reads
// nothing: its outputs are the constant the plain version computes there
// (0 x + 0 x = +0 for finite pixels, so 128/255 on the canvas, 0 in a crop).
//
// Work: a block per band of at most R output rows (canvas rows or crop
// rows) of one sub-frame, from a host-built table (ops/resample.
// k2_block_table: sub-frame, kind, first row, rows, output index, and the
// letterbox band's staged source rows, static per geometry). Sub-frame b of
// frames[::frame_stride] has letterbox bands when b % det_stride == 0 and
// crop bands when b % crop_stride == 0; skipped frames launch nothing. The
// table is frame-major, a frame's letterbox bands then its crop bands, so
// the blocks that read one frame run together while it is in L2.
//
// A block (1) takes its rows' taps (letterbox: the host table; crop: from
// the box) and the staging plan: the contiguous source rows its
// nonzero-weight rows read when that is at most 2R rows (the letterbox's
// plan comes from the table), else two slots per output row (a downscale
// by more than 2, a huge box); (2) copies those rows, over the column span
// the taps read (the letterbox: the whole row; a crop: the columns between
// its first and last column taps), into shared memory with 16-byte
// cp.async, the unaligned ends of a row (W*3 not a multiple of 16, a batch
// slice, a crop's first column) byte by byte, so it never reads outside
// the frame; (3) computes runs of 4 consecutive output pixels per thread
// from shared memory (three 32-bit loads per source pixel pair, exact
// byte-to-float conversions) and writes a warp's 32 runs, one contiguous
// stretch, through a small staging area with 16-byte stores on
// consecutive addresses (value by value where a row holds no whole number
// of runs). Four blocks stay resident an SM (64 registers a thread), so
// the copies of some overlap the compute of others. The host picks R <= 8
// so that 2R staged rows of W*3 bytes stay within 40 KB (R = 8 at W = 800,
// 3 at 1920), and R = 4 where R = 8 would leave fewer bands than 16 an SM
// (the fast step's 8 frames). A persistent, double-buffered form (the next
// band's rows in flight while one computes) was bit-equal but slower at
// every shape measured (PERF.md, K2).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At 64 frames of 450x800, strides
// 1/1 and f32 it moves 69.1 MB of frames read (the letterbox touches every
// pixel), 92.0 MB of letterbox and 38.5 MB of crops written: 199.7 MB,
// about 60 us; the ~20 flops per output value are far below the compute
// roof. The previous version gathered twelve scattered bytes per output
// pixel from global memory and reached 44% of that bound (PERF.md, K2).
// This one is held by instruction throughput and latency, not bytes: ~90
// instructions per output pixel, and its bf16 output, a third fewer bytes,
// is only ~7% faster.

#include "resample_common.cuh"

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident blocks an SM: caps a thread at 64 registers
constexpr int kMaxBand = 8;  // R at most: output rows of a band
constexpr int kRun = 4;      // output pixels a thread computes and stores together
// A block's dynamic shared memory at most: Hopper's 227 KB less 1 KB for
// the kernel's static arrays (the attribute counts both).
constexpr int kMaxSmem = 232448 - 1024;

struct Params {
  const uint8_t* frames;
  int64_t frame_step;  // elements between consecutive sub-frames
  int H, W;
  const int4* table;  // 2 int4 per band (ops/resample.k2_block_table)
  int band_rows, slot_bytes;
  const int4* rows;  // letterbox row taps [i0, i1, bits(w0), bits(w1)]
  const int4* cols;  // letterbox column taps
  int CH, CW;
  void* letter;
  const float* bboxes;
  int64_t bbox_step;
  void* crops;
  int S;
  float scale;
};

// The block's band and its staging plan, in shared memory.
struct Band {
  resample::Taps ty[kMaxBand];
  int off0[kMaxBand], off1[kMaxBand];  // staged byte of column col_lo, rows i0 / i1; -1: no reads
  int src[2 * kMaxBand];               // source row of each slot, -1 for none
  const uint8_t* frame;
  int64_t out;  // element offset of the band's first output value
  int slots, row0, nrows, crop, col_lo, col_hi;
  float half, step_x, cx;
};

__device__ __forceinline__ resample::Taps table_taps(const int4* table, int o) {
  const int4 t = __ldg(table + o);
  resample::Taps r;
  r.i0 = t.x;
  r.i1 = t.y;
  r.w0 = __int_as_float(t.z);
  r.w1 = __int_as_float(t.w);
  return r;
}

// Byte c of `word` as a float, exactly: 2^23 + b has b in its low mantissa bits.
__device__ __forceinline__ float byte_to_float(uint32_t word, int c) {
  return __fsub_rn(__int_as_float(__byte_perm(word, 0x4B000000u, 0x7440u + c)), 8388608.0f);
}

// The source pixels i0 and i1 (i1 = i0 or i0 + 1) of a staged row; `off` is
// pixel i0's byte offset in shared memory. Their channels end up in the low
// three bytes of p0 and p1. Reads up to 11 bytes past `off & ~3`.
__device__ __forceinline__ void pixel_pair(const uint8_t* buf, int off, bool same, uint32_t& p0,
                                           uint32_t& p1) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf + (off & ~3));
  const int sh = (off & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  p0 = __funnelshift_r(w0, w1, sh);
  const uint32_t hi = __funnelshift_r(w1, w2, sh);
  p1 = same ? p0 : __funnelshift_r(p0, hi, 24);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a, the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A thread's run (12 values) into its warp's staging area, lane-major.
__device__ __forceinline__ void put_run(float* stage, const float* v) {
  float4* s = reinterpret_cast<float4*>(stage) + 3 * (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void put_run(__nv_bfloat16* stage, const float* v) {
  uint2* s = reinterpret_cast<uint2*>(stage) + 3 * (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s[k] = make_uint2(pack_bf16(v[4 * k], v[4 * k + 1]), pack_bf16(v[4 * k + 2], v[4 * k + 3]));
}

// (1) Band `band`'s row taps and staging plan into b. Every thread calls it.
__device__ __forceinline__ void plan_band(const Params& p, int band, Band& b) {
  const int4 ea = __ldg(p.table + 2 * band);
  const int4 eb = __ldg(p.table + 2 * band + 1);
  const int sub = ea.x, row0 = ea.z, nrows = ea.w;
  const bool crop = ea.y != 0;
  const uint8_t* frame = p.frames + (int64_t)sub * p.frame_step;
  // The crop's sample grid (resample::crop_pixel's arithmetic) and the
  // columns the taps read: the letterbox reads whole rows; a crop's column
  // taps are monotone in the column, so its span is set by its ends.
  float half = 0.0f, step_x = 0.0f, step_y = 0.0f, cx = 0.0f, cy = 0.0f;
  int col_lo = 0, col_hi = p.W - 1;
  if (crop) {
    const float* bb = p.bboxes + (int64_t)sub * p.bbox_step;
    half = 0.5f * (float)p.S;
    step_x = __fdiv_rn(__fmul_rn(bb[2], p.scale), (float)p.S);
    step_y = __fdiv_rn(__fmul_rn(bb[3], p.scale), (float)p.S);
    cx = bb[0];
    cy = bb[1];
    const resample::Taps a =
        resample::crop_axis_taps(__fadd_rn(__fmul_rn(__fsub_rn(0.0f, half), step_x), cx), p.W);
    const resample::Taps z = resample::crop_axis_taps(
        __fadd_rn(__fmul_rn(__fsub_rn((float)(p.S - 1), half), step_x), cx), p.W);
    col_lo = min(a.i0, z.i0);
    col_hi = max(a.i1, z.i1);
  }
  const int t = threadIdx.x;
  if (t < nrows) {
    b.ty[t] = crop ? resample::crop_axis_taps(
                         __fadd_rn(__fmul_rn(__fsub_rn((float)(row0 + t), half), step_y), cy), p.H)
                   : table_taps(p.rows, row0 + t);
  }
  __syncthreads();
  // Staged rows [lo, lo + n) when n > 0; two slots a row when n < 0; none
  // when 0. The letterbox's come from the table (the host's
  // ops/resample.k2_band_plan), a crop's by the same rule here.
  int lo = eb.y, n = eb.z;
  if (crop) {
    int hi = -1;
    lo = p.H;
    for (int r = 0; r < nrows; ++r) {
      const resample::Taps ty = b.ty[r];
      if (ty.w0 != 0.0f || ty.w1 != 0.0f) {
        lo = min(lo, ty.i0);
        hi = max(hi, ty.i1);
      }
    }
    n = hi < 0 ? 0 : (hi - lo + 1 <= 2 * nrows ? hi - lo + 1 : -1);
  }
  const int slots = n > 0 ? n : (n < 0 ? 2 * nrows : 0);
  if (t < slots) {
    const resample::Taps ty = b.ty[t >> 1];
    const bool used = ty.w0 != 0.0f || ty.w1 != 0.0f;
    b.src[t] = n > 0 ? lo + t : (used ? ((t & 1) ? ty.i1 : ty.i0) : -1);
  }
  if (t < nrows) {
    const resample::Taps ty = b.ty[t];
    const bool used = n != 0 && (ty.w0 != 0.0f || ty.w1 != 0.0f);
    const int k0 = n > 0 ? ty.i0 - lo : 2 * t;
    const int k1 = n > 0 ? ty.i1 - lo : 2 * t + 1;
    // Byte x of a staged row sits at (x - (x0 & ~15)) past its slot, x0 its first byte.
    b.off0[t] = used ? k0 * p.slot_bytes + (int)(reinterpret_cast<uintptr_t>(
                           frame + ((int64_t)ty.i0 * p.W + col_lo) * 3) & 15) : -1;
    b.off1[t] = used ? k1 * p.slot_bytes + (int)(reinterpret_cast<uintptr_t>(
                           frame + ((int64_t)ty.i1 * p.W + col_lo) * 3) & 15) : -1;
  }
  if (t == 0) {
    b.frame = frame;
    b.out = crop ? ((int64_t)eb.x * p.S + row0) * p.S * 3 : ((int64_t)eb.x * p.CH + row0) * p.CW * 3;
    b.slots = slots;
    b.row0 = row0;
    b.nrows = nrows;
    b.crop = crop;
    b.col_lo = col_lo;
    b.col_hi = col_hi;
    b.half = half;
    b.step_x = step_x;
    b.cx = cx;
  }
  __syncthreads();
}

// (2) Copies the band's rows into `buf`, a warp a slot: 16-byte cp.async
// for the aligned interior, the ragged ends byte by byte. Never reads
// outside the frame.
__device__ __forceinline__ void copy_rows(const Params& p, const Band& b, uint8_t* buf) {
  const int span = 3 * (b.col_hi - b.col_lo + 1);
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < b.slots; k += kThreads / 32) {
    const int src = b.src[k];
    if (src < 0) continue;
    const uint8_t* a = b.frame + ((int64_t)src * p.W + b.col_lo) * 3;
    const int mis = (int)(reinterpret_cast<uintptr_t>(a) & 15);
    const int head = min((16 - mis) & 15, span);
    const int chunks = (span - head) >> 4;
    uint8_t* dst = buf + k * p.slot_bytes + mis;
    for (int c = lane; c < chunks; c += 32) cp_async16(dst + head + 16 * c, a + head + 16 * c);
    const int i = lane < 16 ? lane : head + 16 * chunks + lane - 16;
    if (lane < 16 ? i < head : i < span) dst[i] = __ldg(a + i);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// (3) The band's outputs from its staged rows in `buf`; `stage` is the
// warp's staging area of 32 runs.
template <typename OutT>
__device__ __forceinline__ void compute_band(const Params& p, const Band& b, const uint8_t* buf,
                                             OutT* stage) {
  const float inv255 = 1.0f / 255.0f;
  const float gray = (float)(128.0 / 255.0);
  const int lane = threadIdx.x & 31;
  const int out_w = b.crop ? p.S : p.CW;
  const int runs = (out_w + kRun - 1) / kRun;
  const int items = b.nrows * runs;
  OutT* base = static_cast<OutT*>(b.crop ? p.crops : p.letter) + b.out;
  // Whole runs in every row and an aligned start: a warp's 32 runs are one
  // contiguous, 16-byte aligned stretch of the output.
  const bool coalesced = out_w % kRun == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  for (int it0 = (threadIdx.x >> 5) * 32; it0 < items; it0 += kThreads) {
    const int it = it0 + lane;
    const int r = it / runs;
    const int ox0 = (it - r * runs) * kRun;
    const int cnt = it < items ? min(kRun, out_w - ox0) : 0;
    float v[3 * kRun];
    if (cnt > 0) {
      const resample::Taps ty = b.ty[r];
      const int off0 = b.off0[r], off1 = b.off1[r];
      if (off0 < 0) {  // a row with both weights 0: the constant of the plain version
#pragma unroll
        for (int i = 0; i < 3 * kRun; ++i) v[i] = b.crop ? 0.0f : gray;
      } else {
        const float cov_y = __fadd_rn(ty.w0, ty.w1);
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          const int ox = min(ox0 + q, out_w - 1);  // a short run repeats its last pixel
          const resample::Taps tx =
              b.crop ? resample::crop_axis_taps(
                           __fadd_rn(__fmul_rn(__fsub_rn((float)ox, b.half), b.step_x), b.cx), p.W)
                     : table_taps(p.cols, ox);
          const int x = 3 * (min(max(tx.i0, b.col_lo), b.col_hi) - b.col_lo);
          const bool same = tx.i1 == tx.i0;
          uint32_t a0, a1, b0, b1;
          pixel_pair(buf, off0 + x, same, a0, a1);
          pixel_pair(buf, off1 + x, same, b0, b1);
          const float border =
              b.crop ? 0.0f
                     : __fmul_rn(gray, __fsub_rn(1.0f, __fmul_rn(cov_y, __fadd_rn(tx.w0, tx.w1))));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float r0 = __fadd_rn(__fmul_rn(tx.w0, byte_to_float(a0, c)),
                                       __fmul_rn(tx.w1, byte_to_float(a1, c)));
            const float r1 = __fadd_rn(__fmul_rn(tx.w0, byte_to_float(b0, c)),
                                       __fmul_rn(tx.w1, byte_to_float(b1, c)));
            const float s =
                __fmul_rn(__fadd_rn(__fmul_rn(ty.w0, r0), __fmul_rn(ty.w1, r1)), inv255);
            v[3 * q + c] = b.crop ? s : __fadd_rn(s, border);
          }
        }
      }
    }
    if (coalesced) {
      if (cnt > 0) put_run(stage, v);
      __syncwarp();
      const int bytes = min(32, items - it0) * 3 * kRun * (int)sizeof(OutT);
      const uint4* from = reinterpret_cast<const uint4*>(stage);
      uint4* to = reinterpret_cast<uint4*>(base + (int64_t)it0 * 3 * kRun);
      for (int c = lane; c < bytes / 16; c += 32) to[c] = from[c];
      if (bytes % 16 != 0 && lane == 0)  // bf16: an odd number of runs ends on 8 bytes
        reinterpret_cast<uint2*>(to)[bytes / 8 - 1] =
            reinterpret_cast<const uint2*>(from)[bytes / 8 - 1];
      __syncwarp();
    } else if (cnt > 0) {
      OutT* out = base + ((int64_t)r * out_w + ox0) * 3;
#pragma unroll
      for (int i = 0; i < 3 * kRun; ++i)  // static indices keep v in registers
        if (i < 3 * cnt) resample::store(out, i, v[i]);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) letterbox_crop_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Band band;
  OutT* stage = reinterpret_cast<OutT*>(smem + 2 * p.band_rows * p.slot_bytes) +
                (threadIdx.x >> 5) * 32 * 3 * kRun;
  plan_band(p, blockIdx.x, band);
  copy_rows(p, band, smem);
  __syncthreads();
  compute_band<OutT>(p, band, smem, stage);
}

// Lets both instantiations take up to kMaxSmem bytes of dynamic shared
// memory, once per device (bit d of `ready` for device d).
cudaError_t allow_smem() {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(letterbox_crop_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(letterbox_crop_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace

// Plain C interface for ctypes. `table` holds 2 int4 per band (see
// plan_band); band_rows is R, slot_bytes the shared-memory stride of a
// staged row (the kernel reads up to 24 bytes past a row's last pixel
// byte, so at least W*3 + 24, a multiple of 16). frame_step / bbox_step are
// the element distances between consecutive sub-frames (frame_stride times
// the batch stride). bboxes and crops may be null when the table has no
// crop bands. Launches a block per band on `stream`, does not synchronise,
// allocates nothing, and returns the cudaGetLastError() code of the launch
// (0 on success).
extern "C" int letterbox_crop_launch(
    const void* frames, long long frame_step, int H, int W, const void* table, int n_bands,
    int band_rows, int slot_bytes, const void* rows, const void* cols, int CH, int CW,
    void* letter, const void* bboxes, long long bbox_step, void* crops, int S, float scale,
    int out_bf16, void* stream) {
  if (n_bands <= 0) return 0;
  // 2R staged rows, then each warp's 32 runs of 12 values.
  const size_t smem =
      (size_t)2 * band_rows * slot_bytes + (size_t)kThreads * 3 * kRun * (out_bf16 ? 2 : 4);
  if (band_rows < 1 || band_rows > kMaxBand || slot_bytes % 16 || slot_bytes < 3 * W + 24 ||
      smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const Params p{static_cast<const uint8_t*>(frames), frame_step, H, W,
                 static_cast<const int4*>(table), band_rows, slot_bytes,
                 static_cast<const int4*>(rows), static_cast<const int4*>(cols), CH, CW,
                 letter, static_cast<const float*>(bboxes), bbox_step, crops, S, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16) {
    letterbox_crop_kernel<__nv_bfloat16><<<n_bands, kThreads, smem, st>>>(p);
  } else {
    letterbox_crop_kernel<float><<<n_bands, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* letterbox_crop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
