// Kernel K5 on Hopper: one int8 Darknet-53 residual stage, 2n + 1 launches.
//
// Replaces the TPU kernel fused_residual_stage
// (poserisk_release_tpu/ops/yolo_stage_pallas.py:147, body _stage_kernel at
// :107). Each residual block j of the stage computes, on the f32 stream h
// (M = B*H*W rows of C channels):
//   q  = clip(rint(h * inv1), +-127)             (s8)
//   a  = leaky(d1 * (q x qk1) + b1)              1x1: K = C, N = C/2
//   aq = clip(rint(a * inv3), +-127)             (s8, written to `aq`)
//   y  = leaky(d3 * conv3x3(aq, qk3) + b3)       3x3: K = 9*C/2, N = C
//   h  = h + y
// The plain version is ops/yolo_stage.fused_residual_stage_plain.
//
// Bound on an H100 SXM: 10*H*W*C^2 int8 operations per block and frame
// (1.23 G at every stage shape of the 288x416 canvas) against 1,979 TOPS of
// dense int8: 0.317 ms per 8-block stage at B = 64, 0.794 ms over the three
// stages (tools/exp_fused_stage.stage_bound). The TPU kernel keeps a frame's
// f32 stream in VMEM across the stage; an SM has 227 KB of shared memory and
// blocks run in no order, so here the stream stays in device memory and
// the design cannot go below its bytes (tools/exp_fused_stage.stage_floor):
// the stage's input read twice (quantize, first 3x3) and its output written
// once at their own width, the f32 stream between blocks written and read
// once, q written and read once per block, aq written once (its reads hit
// L2), and the weights once: 82 bytes per element of an 8-block bf16 stage,
// ~0.75 ms at C256 and B = 64, ~0.38 at C512, and at C1024 (stream in L2)
// the operations' 0.16 ms: ~1.29 ms a pass.
//
// What the first version lost, and what this one does about each:
// 1. Loads did not overlap math (each 64-deep K tile went global ->
//    registers -> shared between two barriers). Here every operand tile is
//    a cp.async 16-byte copy into a ring of 3 stages: the next 2 tiles are
//    in flight while tile k is multiplied.
// 2. Small mma.sync tiles. Here the products are
//    wgmma.mma_async.m64n128k32.s32.s8.s8, A and B both K-major in shared
//    memory in the 128-byte swizzle their descriptors name; K tiles are 128
//    bytes deep (four k32 steps); a CTA tile is 128 rows (two warpgroups of
//    64) by 128 columns in both GEMMs, and two such CTAs share an SM (a
//    256-column tile holds one CTA an SM and was slower at every stage on
//    an H100).
// 3. The 1x1 re-read and re-quantized the f32 stream once per N tile. Here
//    the handoff between blocks is quantized: the 3x3 epilogue of block j
//    writes h + y to the stream and also q_{j+1} = quant(h + y, inv1[j+1])
//    as int8 (block 0's q comes from one quantize launch), so the 1x1 reads
//    only int8 and never the stream. Exact: quant is elementwise on the same
//    f32 value the stream stores. One q buffer serves the stage, because
//    stream order puts block j's 1x1 before its 3x3.
// 4. Bytes: per block the stream is read and written once, by the 3x3
//    epilogue, which stages its tile through shared memory so that each
//    warp moves whole 512-byte row segments; q (a quarter of the stream) is
//    written once and read once per 1x1 N tile (1, 2 and 4 tiles at C256,
//    C512 and C1024); aq is written once and gathered 9 times, from L2.
//
// Rounding, so that the card equals the plain version bit for bit: every
// product and sum is rounded on its own (__int2float_rn, __fmul_rn,
// __fadd_rn, in the TPU kernel's order, no FMA contraction), rintf for
// round-half-to-even, and leaky as y > 0 ? y : 0.1f * y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;         // two warpgroups
constexpr int kBM = 128;              // CTA rows, 64 per warpgroup
constexpr int kBK = 128;              // K-tile depth in bytes: four k32 steps
constexpr int kATile = kBM * kBK;     // 16 KB

constexpr int kBN = 128;              // CTA columns of both GEMMs
constexpr int kStages = 3;            // depth of the ring
constexpr int kStage = kATile + kBN * kBK;
constexpr int kSmem = kStages * kStage + 1024;  // + room to align to 1 KB; two CTAs an SM

__device__ __forceinline__ int8_t quant(float x, float inv_s) {
  float q = rintf(__fmul_rn(x, inv_s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float leaky(float y) { return y > 0.0f ? y : __fmul_rn(0.1f, y); }

// d * acc + b with each operation rounded on its own.
__device__ __forceinline__ float affine(int acc, float d, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), d), b);
}

// Byte offset of 16-byte chunk `chunk` of tile row `row` in the 128-byte
// swizzle (the chunk index XOR the row within its 8-row, 1 KB atom).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kBK + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes global -> shared, or 16 zero bytes (src-size 0) when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const int8_t* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed copies visible to wgmma's (async) proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A K-major operand in the 128-byte swizzle: 128-byte rows, 8-row atoms
// 1024 bytes apart (stride byte offset), leading byte offset unused (1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128, s32) += A (64 x 32, s8) x B (32 x 128, s8), A and B K-major
// in shared memory; acc holds the thread's 64 values of D.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The ring: S stages of (A 128 x 128 B, B 128 x 128 B). Tiles kt + 1 ..
// kt + S - 1 are in flight while tile kt is multiplied; each tile's
// products are waited for before the barrier that frees its stage.
// load(kt, stage_address) issues the thread's copies of K tile kt.
template <typename Load>
__device__ __forceinline__ void mainloop(const Load& load, int KT, uint32_t base,
                                         int (&acc)[kBN / 2]) {
  constexpr int S = kStages;
  const uint32_t a_off = (threadIdx.x >> 7) * (64 * kBK);  // the warpgroup's 64 rows
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, base + s * kStage);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();  // this thread's copies of tile kt have landed
    fence_async_shared();
    __syncthreads();  // everyone's have, and wgmma kt - 1 is done everywhere
    const int nk = kt + S - 1;
    if (nk < KT) load(nk, base + (nk % S) * kStage);
    cp_async_commit();
    const uint32_t st = base + (kt % S) * kStage;
    const uint64_t da = smem_desc(st + a_off), db = smem_desc(st + kATile);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) wgmma_s8(acc, da + 2 * s, db + 2 * s);  // +32 bytes
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
}

// The thread's copies of a kBN-row tile of a K-contiguous int8 matrix (ld
// bytes a row, N rows): chunk c of rows row0, row0 + 32, ...
__device__ __forceinline__ void load_b(uint32_t dst, const int8_t* w, int ld, int N, int n0,
                                       int kk, bool k_ok, int row0, int c) {
#pragma unroll
  for (int i = 0; i < kBN / 32; ++i) {
    const int r = row0 + 32 * i, n = n0 + r;
    const bool ok = k_ok && n < N;
    cp_async16(dst + swz(r, c), w + (ok ? (int64_t)n * ld + kk : 0), ok);
  }
}

// wgmma's D fragment: thread t of warpgroup g holds, for each 8-column
// group j, acc[4j + 2h + e] at row g*64 + (t/32)*16 + (t%32)/4 + 8h and
// column 8j + 2*(t%4) + e of the CTA tile.
__device__ __forceinline__ int frag_row() {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

__device__ __forceinline__ uint32_t aligned_smem_base(const uint8_t* smem) {
  return ((uint32_t)__cvta_generic_to_shared(smem) + 1023) & ~1023u;
}

// Four consecutive stream values at element i (f32 or bf16), as f32, and
// their store.
__device__ __forceinline__ float4 load4(const void* p, int bf16, int64_t i) {
  if (!bf16) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ void store4(void* p, int bf16, int64_t i, float4 v) {
  if (!bf16) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
    return;
  }
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(v.x);
  a.y = __float2bfloat16_rn(v.y);
  b.x = __float2bfloat16_rn(v.z);
  b.y = __float2bfloat16_rn(v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
}

// (a) The 1x1 conv: aq = quant(leaky(d1 * (q x qk1) + b1), inv3); q and aq
// are (M, C) and (M, C/2) int8, w1t is (C/2, C).
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w1t,
               const float* __restrict__ d1, const float* __restrict__ b1, float inv3,
               int8_t* __restrict__ aq, int M, int C) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = aligned_smem_base(smem);
  const int N = C >> 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int c = threadIdx.x & 7, row0 = threadIdx.x >> 3;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;

  auto load = [&](int kt, uint32_t st) {
    const int kk = kt * kBK + c * 16;
    const bool k_ok = kk < C;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const int r = row0 + 32 * i, m = m0 + r;
      const bool ok = k_ok && m < M;
      cp_async16(st + swz(r, c), q + (ok ? (int64_t)m * C + kk : 0), ok);
    }
    load_b(st + kATile, w1t, C, N, n0, kk, k_ok, row0, c);
  };
  mainloop(load, (C + kBK - 1) / kBK, base, acc);

  // Epilogue through shared memory: aq's int8 tile is stored in wgmma's
  // fragment layout, then written out 16 contiguous bytes a thread.
  constexpr int kPitch = kBN + 16;  // bytes a row: conflict-free fragment stores
  static_assert(kBM * kPitch <= kStages * kStage, "aq tile > ring");
  int8_t* as = reinterpret_cast<int8_t*>(smem + (base - (uint32_t)__cvta_generic_to_shared(smem)));
  __syncthreads();  // both warpgroups' products are done with the ring
  const int fr = frag_row(), fc = frag_col();
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + fc + 8 * j;
    if (col >= N) continue;
    const float2 d = *reinterpret_cast<const float2*>(d1 + col);
    const float2 b = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<char2*>(as + (fr + 8 * h) * kPitch + fc + 8 * j) =
          make_char2(quant(leaky(affine(acc[4 * j + 2 * h], d.x, b.x)), inv3),
                     quant(leaky(affine(acc[4 * j + 2 * h + 1], d.y, b.y)), inv3));
  }
  __syncthreads();
  constexpr int kChunks = kBN / 16;  // 16-byte chunks a tile row
#pragma unroll
  for (int e = threadIdx.x; e < kBM * kChunks; e += kThreads) {
    const int r = e / kChunks, col = n0 + (e % kChunks) * 16, row = m0 + r;
    if (row < M && col < N)
      *reinterpret_cast<int4*>(aq + (int64_t)row * N + col) =
          *reinterpret_cast<const int4*>(as + r * kPitch + (e % kChunks) * 16);
  }
}

// (b) The 3x3 conv on aq (zero padding as the copies' zero fill) and the
// shortcut: out = h + leaky(d3 * conv3x3(aq, qk3) + b3), and, unless q_next
// is null, q_next = quant(out, inv_next) from the f32 sum. h and out may
// alias (the f32 stream); w3t is (C, 9*C/2) with (ky, kx, cin)-major K.
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const void* h, int in_bf16, void* out, int out_bf16, int8_t* __restrict__ q_next,
               float inv_next, const int8_t* __restrict__ aq, const int8_t* __restrict__ w3t,
               const float* __restrict__ d3, const float* __restrict__ b3, int M, int H, int W,
               int C) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = aligned_smem_base(smem);
  const int half = C >> 1, K = 9 * half;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int c = threadIdx.x & 7, row0 = threadIdx.x >> 3;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;

  // The pixel (row of aq), y and x of each A row this thread copies.
  int pix[kBM / 32], py[kBM / 32], px[kBM / 32];
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const int m = m0 + row0 + 32 * i;
    const int r = m % (H * W);
    pix[i] = m < M ? m : -1;
    py[i] = r / W;
    px[i] = r - py[i] * W;
  }
  auto load = [&](int kt, uint32_t st) {
    const int kk = kt * kBK + c * 16;
    const bool k_ok = kk < K;
    const int tap = k_ok ? kk / half : 0, cin = kk - tap * half;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const bool ok = k_ok && pix[i] >= 0 && (unsigned)(py[i] + dy) < (unsigned)H &&
                      (unsigned)(px[i] + dx) < (unsigned)W;
      cp_async16(st + swz(row0 + 32 * i, c),
                 aq + (ok ? (int64_t)(pix[i] + dy * W + dx) * half + cin : 0), ok);
    }
    load_b(st + kATile, w3t, K, C, n0, kk, k_ok, row0, c);
  };
  mainloop(load, (K + kBK - 1) / kBK, base, acc);

  // Epilogue through shared memory (the ring is free once both
  // warpgroups' products are done): y = leaky(d3 * acc + b3) is stored in
  // wgmma's fragment layout, then each warp reads back whole row segments,
  // so the stream, out and q_next move 512 contiguous bytes per warp and a
  // thread has kBatch stream loads in flight (h and out may alias, so the
  // loads are issued explicitly before the stores).
  constexpr int kPitch = kBN + 8;  // floats a row: conflict-free fragment stores
  static_assert(kBM * kPitch * 4 <= kStages * kStage, "y tile > ring");
  float* ys = reinterpret_cast<float*>(smem + (base - (uint32_t)__cvta_generic_to_shared(smem)));
  __syncthreads();
  const int fr = frag_row(), fc = frag_col();
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + fc + 8 * j;
    if (col >= C) continue;
    const float2 d = *reinterpret_cast<const float2*>(d3 + col);
    const float2 b = *reinterpret_cast<const float2*>(b3 + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ys + (fr + 8 * hh) * kPitch + fc + 8 * j) =
          make_float2(leaky(affine(acc[4 * j + 2 * hh], d.x, b.x)),
                      leaky(affine(acc[4 * j + 2 * hh + 1], d.y, b.y)));
  }
  __syncthreads();

  constexpr int kVecs = kBN / 4;                 // float4s a tile row
  constexpr int kRowsPerPass = kThreads / kVecs;
  constexpr int kBatch = 8;
  const int cv = threadIdx.x % kVecs, rr = threadIdx.x / kVecs;
  const int col = n0 + 4 * cv;
#pragma unroll 1
  for (int p0 = 0; p0 < kBM / kRowsPerPass; p0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = m0 + (p0 + u) * kRowsPerPass + rr;
      if (col < C && row < M) x[u] = load4(h, in_bf16, (int64_t)row * C + col);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = (p0 + u) * kRowsPerPass + rr, row = m0 + r;
      if (col >= C || row >= M) continue;
      const float4 y = *reinterpret_cast<const float4*>(ys + r * kPitch + 4 * cv);
      const float4 v = make_float4(__fadd_rn(x[u].x, y.x), __fadd_rn(x[u].y, y.y),
                                   __fadd_rn(x[u].z, y.z), __fadd_rn(x[u].w, y.w));
      const int64_t i = (int64_t)row * C + col;
      store4(out, out_bf16, i, v);
      if (q_next != nullptr)
        *reinterpret_cast<char4*>(q_next + i) =
            make_char4(quant(v.x, inv_next), quant(v.y, inv_next), quant(v.z, inv_next),
                       quant(v.w, inv_next));
    }
  }
}

// Block 0's q: q = quant(h, inv1) over n8 groups of 8 elements.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
    v[2 * k] = __low2float(b);
    v[2 * k + 1] = __high2float(b);
  }
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ h, int8_t* __restrict__ q, float inv,
                                int64_t n8) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    float v[8];
    load8(h + i * 8, v);
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k >> 2] |= (uint32_t)(uint8_t)quant(v[k], inv) << (8 * (k & 3));
    *reinterpret_cast<uint2*>(q + i * 8) = make_uint2(w[0], w[1]);
  }
}

// Lets both GEMM kernels take kSmem bytes of dynamic shared memory, once
// per device (bit d of `ready` for device d), not before every launch.
cudaError_t allow_smem() {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(conv1x1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

cudaError_t launch_1x1(const int8_t* q, const int8_t* w1t, const float* d1, const float* b1,
                       float inv3, int8_t* aq, int M, int C, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, (C / 2 + kBN - 1) / kBN);
  conv1x1_kernel<<<grid, kThreads, kSmem, st>>>(q, w1t, d1, b1, inv3, aq, M, C);
  return cudaGetLastError();
}

cudaError_t launch_3x3(const void* h, int in_bf16, void* out, int out_bf16, int8_t* q_next,
                       float inv_next, const int8_t* aq, const int8_t* w3t, const float* d3,
                       const float* b3, int M, int H, int W, int C, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, (C + kBN - 1) / kBN);
  conv3x3_kernel<<<grid, kThreads, kSmem, st>>>(
      h, in_bf16, out, out_bf16, q_next, inv_next, aq, w3t, d3, b3, M, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: the whole stage on `stream`, h (B, H, W, C)
// -> out, f32 or bf16 each. n_blocks >= 1 blocks of stacked weights (w1t
// (n, C/2, C), w3t (n, C, 9*C/2), d1/b1 (n, C/2), d3/b3 (n, C) f32), inv_s
// (n, 2) f32 in host memory. Scratch from the caller: stream_buf (B*H*W, C)
// f32 when n_blocks > 1, q (B*H*W, C) and aq (B*H*W, C/2) int8. Launches 2n + 1
// kernels (quantize, then the 1x1 and the 3x3 of each block), checks
// cudaGetLastError() after each, does not synchronise, allocates nothing;
// returns the first error code (0 on success). C must be a multiple of 128.
extern "C" int yolo_stage_launch(const void* h, int in_bf16, void* out, int out_bf16,
                                 void* stream_buf, void* q, void* aq, const void* w1t,
                                 const void* d1, const void* b1, const void* w3t, const void* d3,
                                 const void* b3, const float* inv_s, int n_blocks, int B, int H,
                                 int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C % 128 || n_blocks < 1 || (n_blocks > 1 && stream_buf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * H * W, half = C / 2;
  int8_t* qb = static_cast<int8_t*>(q);
  int8_t* ab = static_cast<int8_t*>(aq);

  const int64_t n8 = (int64_t)M * C / 8;
  const int qgrid = (int)((n8 + 255) / 256 < 65536 ? (n8 + 255) / 256 : 65536);
  if (in_bf16)
    quantize_kernel<<<qgrid, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(h), qb, inv_s[0], n8);
  else
    quantize_kernel<<<qgrid, 256, 0, st>>>(static_cast<const float*>(h), qb, inv_s[0], n8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  for (int j = 0; j < n_blocks; ++j) {
    const int8_t* k1 = static_cast<const int8_t*>(w1t) + (int64_t)j * half * C;
    const float* pd1 = static_cast<const float*>(d1) + (int64_t)j * half;
    const float* pb1 = static_cast<const float*>(b1) + (int64_t)j * half;
    err = launch_1x1(qb, k1, pd1, pb1, inv_s[2 * j + 1], ab, M, C, st);
    if (err != cudaSuccess) return (int)err;

    const bool first = j == 0, last = j == n_blocks - 1;
    const void* src = first ? h : stream_buf;
    void* dst = last ? out : stream_buf;
    int8_t* q_next = last ? nullptr : qb;
    const float inv_next = last ? 0.0f : inv_s[2 * (j + 1)];
    const int8_t* k3 = static_cast<const int8_t*>(w3t) + (int64_t)j * C * 9 * half;
    const float* pd3 = static_cast<const float*>(d3) + (int64_t)j * C;
    const float* pb3 = static_cast<const float*>(b3) + (int64_t)j * C;
    const int src_bf16 = first ? in_bf16 : 0, dst_bf16 = last ? out_bf16 : 0;
    err = launch_3x3(src, src_bf16, dst, dst_bf16, q_next, inv_next, ab, k3, pd3, pb3, M, H, W,
                     C, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* yolo_stage_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
