// K2 on Hopper: masked multi-head attention with an online softmax, on the
// tensor cores (wgmma), reading strided heads.
//
// Replaces the TPU kernel capreolus_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_attention_tpu). For each (batch b, head h) and query
// row i of q, k, v [B, H, L, D] and the key mask [B, L]:
//   s[j]   = <q[i] * (1/sqrt(D)), k[j]>          in f32
//          , -1e30 where mask[b, j] == 0
//   out[i] = sum_j exp(s[j] - m) v[j] / max(sum_j exp(s[j] - m), 1e-30)
// with the max m, the sum and the accumulator carried across key tiles as an
// online softmax in f32, and the output in the input dtype. A row whose keys
// are all masked gets the mean of V, as in both JAX paths at f32. The [L, L]
// score matrix never reaches device memory.
//
// Layout: q, k and v may have any element strides over (b, h, l) as long as D
// is contiguous and every stride and base is a multiple of 16 bytes: in
// practice x.view(B, L, H, D).transpose(1, 2) of a projection's [B, L, H * D]
// output, so the encoder splits its heads without a copy. TMA reads them
// through 4-D tensor maps over (D, H, L, B) (or (D, L, H, B), whichever order
// the strides grow in). The output is written [B, L, H, D], so merging the
// heads afterwards is a view too. D in {32, 64, 128}, any L >= 1 (TMA
// zero-fills rows past L, and those keys get no weight).
//
// What bounds it on an H100. At the served monoBERT shape (B = 1600 passages,
// H = 12, L = 256, D = 64, f32, about 30% of keys unmasked, as a prefix) it
// must read q and write the output (2.5 GB) and read the unmasked keys' k and
// v rows (0.8 GB): about 1.0 ms at 3.35 TB/s. Its 98 GFLOP take 1.5 ms at the
// 67 TFLOP/s f32 rate of the CUDA cores, but three TF32 products each, 0.6 ms,
// at the 495 TFLOP/s TF32 tensor-core rate: so bytes. In bf16 with every key
// unmasked: 2.5 GB, 0.75 ms, against 322 GFLOP in 0.33 ms at 989 TFLOP/s.
// chip_smoke.py counts the bound from each run's mask.
//
// Design: one block of two consumer warpgroups per (b, h, 128 query rows),
// each warpgroup 64 rows; keys in tiles of 64 that thread 0 loads by TMA into
// a ring of mbarrier-tracked stages ahead of use, shared by both warpgroups
// (in bf16 each warp releases a stage through a second mbarrier, so the two
// warpgroups drift apart and one's softmax overlaps the other's products).
// Per tile a warpgroup computes S = q k^T with wgmma, runs the online softmax
// in registers on the accumulator fragments (each warp reads the tile's mask
// with two byte loads and two ballots; exp as exp2 of a product with
// log2(e)), and adds P v with wgmma, P taken from those registers.
// - bf16: wgmma.m64n64k16 for S, q and k read by descriptor from the 128-byte
//   (D = 32: 64-byte) swizzle TMA writes; wgmma.m64nDk16 for P v with P
//   rounded to bf16 (the MXU's precision at its default: the score
//   accumulator's layout is the A fragment's) and v read MN-major through the
//   transpose bit. The scale applies to the f32 scores (for D = 64 the same
//   values as scaling q, since 1/8 is exact).
// - f32 (the served dtype): split TF32 ("3xTF32") on wgmma.m64nNk8.tf32. Each
//   operand x = hi + lo with hi = tf32(x) (round to nearest) and lo = x - hi,
//   and a product is lo*hi' + hi*lo' + hi*hi', the large term last; the
//   dropped lo*lo' is 2^-22 of it, so the result keeps f32 accuracy (plain
//   TF32 or bf16 would not: that is a separate decision for the serving
//   precision). q is scaled first, in f32, and stays in registers as A
//   fragments. The 256 threads transpose each v tile into v^T's hi and lo
//   parts (TF32 wgmma reads only K-major operands), in the 128-byte swizzle
//   the descriptors name, with each 8-key step's keys in the order
//   (2t, 2t + 1 -> k = t, t + 4) in which the P fragment already holds its
//   probabilities; then they split the k tile in place (hi) and into the
//   freed v slot (lo).
// Masked tiles: when a batch element has at least one unmasked key, a tile of
// keys that are all masked adds exactly nothing (exp(-1e30 - m) is 0 in f32
// for any finite score m, and a later tile's rescale by exp(-1e30 - m) = 0
// clears what an earlier one added), so such tiles are never loaded; the pad
// passages of BERT-MaxP serving are mostly masked keys. A batch element with
// no unmasked key runs every tile, giving the mean of V. Masked query rows
// are computed like any other: their outputs are part of the function.
// Sums run in a fixed order and nothing is atomic, so a result is the same
// from run to run.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // two consumer warpgroups; thread 0 also issues the TMA loads
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;  // [B, L], nonzero = attend
  void* out;                  // [B, L, H, D]
  long long sq[3], sk[3], sv[3];  // element strides over (b, h, l)
  int H, L;
  int nqb;     // query blocks per (b, h)
  int ntiles;  // key tiles
  float scale;
};

// per key tile, 1 where it holds an unmasked key; returns whether any key is unmasked
__device__ __forceinline__ bool tile_flags(const unsigned char* mrow, int L, int ntiles, int* flags) {
  for (int t = threadIdx.x; t < ntiles; t += kThreads) flags[t] = 0;
  __syncthreads();
  int any = 0;
  for (int j = threadIdx.x; j < L; j += kThreads) {
    if (mrow[j]) {
      flags[j / kBK] = 1;  // every writer stores the same value
      any = 1;
    }
  }
  return __syncthreads_or(any) != 0;
}

// the first tile at or after t that has to run
__device__ __forceinline__ int next_tile(const int* flags, int t, int ntiles, bool skip) {
  if (skip) {
    while (t < ntiles && !flags[t]) ++t;
  }
  return t;
}

// The tile's mask for this warp: bit i of even / odd says whether key key0 +
// 2i / key0 + 2i + 1 is unmasked (two byte loads and two ballots per warp).
struct TileMask {
  uint32_t even, odd;
  int valid;  // keys of the tile below L
};

__device__ __forceinline__ TileMask tile_mask(const unsigned char* mrow, int key0, int L) {
  const int lane = threadIdx.x % 32;
  const int k0 = key0 + 2 * lane;
  TileMask tm;
  tm.even = __ballot_sync(0xffffffffu, k0 < L && __ldg(mrow + k0) != 0);
  tm.odd = __ballot_sync(0xffffffffu, k0 + 1 < L && __ldg(mrow + k0 + 1) != 0);
  tm.valid = L - key0;
  return tm;
}

// The online softmax of one 64-key tile on a warp's 16 query rows, in the
// wgmma m64nN accumulator layout: s[4j + c] is row g, key 8j + 2t + c, and
// s[4j + 2 + c] row g + 8 (g = lane / 4, t = lane % 4). s holds unscaled
// scores; masked keys become -1e30 / scale (-1e30 once scaled) and keys past
// L -inf (no weight at all); then p = exp(scale (s - m_new)) as exp2 of a
// product with scale log2(e), the row max m (unscaled) and sum l are
// updated, and each row's rescale exp(scale (m_old - m_new)) is returned in
// alpha. A tile whose keys are all unmasked and inside L skips the masking
// (the test is uniform across the warp). The four threads of a row reduce in
// a fixed order.
__device__ __forceinline__ void online_softmax(float (&s)[32], const TileMask& tm, float scale, float (&m)[2],
                                               float (&l)[2], float (&alpha)[2]) {
  const int t = threadIdx.x % 4;
  float mx[2] = {m[0], m[1]};
  if ((tm.even & tm.odd) == 0xffffffffu && tm.valid >= kBK) {
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j]);
  } else {
    const float masked = kMasked / scale;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool past = 8 * j + 2 * t + c >= tm.valid;
        const bool attend = ((c ? tm.odd : tm.even) >> (4 * j + t)) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + c];
          x = attend ? x : (past ? -INFINITY : masked);
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
  }
  // the difference first: it is exactly 0 where a score equals the max, even
  // at the -1e30 of a row whose keys are all masked
  const float c2 = scale * kLog2e;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f((m[h] - mx[h]) * c2);
    m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s[4 * j + r] = exp2f((s[4 * j + r] - mx[r / 2]) * c2);
      sum[r / 2] += s[4 * j + r];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

// d[64 x 64] (+)= a[64 x 16] * b[64 x 16]^T, both K-major in shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] += a[64 x 16] * b[16 x 32]: a in registers (bf16 pairs), b MN-major in shared memory
// (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 16] * b[16 x 64]: a in registers (bf16 pairs), b MN-major in shared memory
// (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 16] * b[16 x 128]: a in registers (bf16 pairs), b MN-major in shared memory
// (the transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] (+)= a[64 x 8] * b[32 x 8]^T in TF32: a in registers, b K-major in shared memory;
// scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= a[64 x 8] * b[64 x 8]^T in TF32: a in registers, b K-major in shared memory;
// scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= a[64 x 8] * b[128 x 8]^T in TF32: a in registers, b K-major in shared memory;
// scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_m64n32k16_rs(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_m64n64k16_rs(d, a, db);
  } else {
    wgmma_m64n128k16_rs(d, a, db);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv_tf32(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_m64n32k8_tf32(d, a, db, 1);
  } else if constexpr (D == 64) {
    wgmma_m64n64k8_tf32(d, a, db, 1);
  } else {
    wgmma_m64n128k8_tf32(d, a, db, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x = hi + lo: hi rounded to TF32, lo the exact rest (whose bits below TF32 the tensor core drops)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Shared memory of a block, by dtype and head dim. TMA writes 64-row tiles
// as boxes of 64 rows x kBoxD values, one swizzle row of kRowBytes each.
// bf16: q's two tiles, then the ring of k and v tiles (four stages while a
// block still fits twice on an SM). f32: the ring, then v^T's high and low
// parts, [D rows][64 keys] as two boxes of 32 keys; k's low parts go to the
// v slot of their stage once v is transposed.
template <typename T, int D>
struct Geometry {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBoxD = kF32 ? 32 : (D < 64 ? D : 64);
  static constexpr int kBoxes = D / kBoxD;
  static constexpr uint32_t kRowBytes = kBoxD * sizeof(T);  // 128, or 64 for bf16 at D = 32
  static constexpr uint32_t kBoxBytes = 64 * kRowBytes;
  static constexpr uint32_t kTile = kBoxes * kBoxBytes;     // 64 rows of D values
  static constexpr uint32_t kVtBox = D * 128;               // a box of v^T: D rows of 32 f32 keys
  static constexpr int kStages = kF32 ? 2 : (D <= 64 ? 4 : 2);
  static constexpr uint32_t kRing = kF32 ? 0 : 2 * kTile;
  static constexpr uint32_t kVtHi = kRing + 2 * kStages * kTile;
  static constexpr uint32_t kVtLo = kVtHi + kTile;
  static constexpr uint32_t kBars = kF32 ? kVtLo + kTile : kVtHi;
  static constexpr int kNumBars = kF32 ? kStages + 1 : 2 * kStages + 1;  // full[S], (bf16) empty[S], q's
  static constexpr int kSmem = 1024 + kBars + 8 * kNumBars;              // + the tile flags
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // wgmma: 128B or 64B
};

// f32: v's tile ([64 keys][D] in TMA's 128-byte swizzle) to v^T's TF32 high
// and low parts, K-major for the P v product; then, the v slot free, k's tile
// to its high parts in place and its low parts at the same offsets in the v
// slot. The writes are made visible to wgmma's reads before it returns.
template <int D>
__device__ __forceinline__ void split_kv(uint8_t* k, uint8_t* v, uint8_t* vthi, uint8_t* vtlo) {
  // a lane per key of a 32-key half, a warp per 4-column chunk: the reads of
  // 8 lanes fall in 8 distinct 16-byte chunks (the swizzle), the writes of a
  // warp in 32 distinct banks
  const int lane = threadIdx.x % 32;
#pragma unroll 2
  for (int idx = threadIdx.x / 32; idx < 2 * (D / 4); idx += kThreads / 32) {
    const int half = idx % 2, c4 = idx / 2;
    const int key = 32 * half + lane;
    const float4 x = *reinterpret_cast<const float4*>(v + (c4 / 8) * 8192 + key * 128 + ((c4 % 8) ^ (key % 8)) * 16);
    const int pos = 8 * (lane / 8) + (lane % 8) / 2 + 4 * (lane % 2);  // the key's place in its box row
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * c4 + i;
      const int off = half * (D * 128) + d * 128 + (((pos / 4) ^ (d % 8)) * 16) + (pos % 4) * 4;
      uint32_t hi, lo;
      split_tf32(xs[i], hi, lo);
      *reinterpret_cast<uint32_t*>(vthi + off) = hi;
      *reinterpret_cast<uint32_t*>(vtlo + off) = lo;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * D / 4; idx += kThreads) {
    const float4 x = reinterpret_cast<const float4*>(k)[idx];
    uint32_t hi[4], lo[4];
    split_tf32(x.x, hi[0], lo[0]);
    split_tf32(x.y, hi[1], lo[1]);
    split_tf32(x.z, hi[2], lo[2]);
    split_tf32(x.w, hi[3], lo[3]);
    reinterpret_cast<uint4*>(k)[idx] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(v)[idx] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the writes, to wgmma's reads
  __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1) attention_kernel(const __grid_constant__ CUtensorMap map_q,
                                                             const __grid_constant__ CUtensorMap map_k,
                                                             const __grid_constant__ CUtensorMap map_v,
                                                             const Args a, int l_first) {  // bit i: operand i's
  using G = Geometry<T, D>;                                                                 // map is (D, L, H, B)
  constexpr bool F32 = G::kF32;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + G::kBars;  // full[S], then (bf16) empty[S], then q's
  const uint32_t qbar = bars + 8 * (G::kNumBars - 1);
  int* flags = reinterpret_cast<int*>(sbase + G::kBars + 8 * G::kNumBars);

  const int bh = blockIdx.x / a.nqb, b = bh / a.H, h = bh % a.H;
  const int wg = threadIdx.x / 128;  // this warpgroup's rows: row0 .. row0 + 63
  const int row0 = (blockIdx.x % a.nqb) * kBQ + 64 * wg;
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const unsigned char* mrow = a.mask + static_cast<size_t>(b) * a.L;
  const bool leader = threadIdx.x == 0;

  // one 64-row tile of (b, h) of operand `which` from rows r0: D / kBoxD boxes
  auto load = [&](uint32_t dst, const CUtensorMap* map, int which, uint32_t bar, int r0) {
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x) {
      if ((l_first >> which) & 1) {
        tma_load(dst + x * G::kBoxBytes, map, bar, x * G::kBoxD, r0, h, b);
      } else {
        tma_load(dst + x * G::kBoxBytes, map, bar, x * G::kBoxD, h, r0, b);
      }
    }
  };
  // k and v of key tile `tile` into ring slot n. bf16: once both warpgroups
  // have released the slot's last use (f32 synchronizes the block per tile).
  auto load_kv = [&](int n, int tile) {
    if (!F32 && n >= S) mbar_wait(bars + 8 * (S + n % S), (n / S + 1) & 1);
    const uint32_t full = bars + 8 * (n % S);
    const uint32_t dst = base + G::kRing + 2 * (n % S) * G::kTile;
    mbar_expect_tx(full, 2 * G::kTile);
    load(dst, &map_k, 1, full, tile * kBK);
    load(dst + G::kTile, &map_v, 2, full, tile * kBK);
  };

  if (leader) {
    for (int i = 0; i < G::kNumBars; ++i) mbar_init(bars + 8 * i, !F32 && i >= S && i < 2 * S ? kThreads / 32 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (!F32) {  // q's rows of both warpgroups; a tile wholly past L is left out
      const int q0 = row0;
      const bool second = q0 + 64 < a.L;
      mbar_expect_tx(qbar, (second ? 2 : 1) * G::kTile);
      load(base, &map_q, 0, qbar, q0);
      if (second) load(base + G::kTile, &map_q, 0, qbar, q0 + 64);
    }
  }
  const bool skip = tile_flags(mrow, a.L, a.ntiles, flags);  // also the barrier after the init
  int tile = next_tile(flags, 0, a.ntiles, skip);
  // the ring runs S - 1 tiles ahead of the one being computed
  int ahead = tile, issued = 0;
  for (; issued < S - 1 && ahead < a.ntiles; ++issued) {
    if (leader) load_kv(issued, ahead);
    ahead = next_tile(flags, ahead + 1, a.ntiles, skip);
  }
  __syncwarp();

  // f32: the warp's 16 query rows as TF32 A fragments (a0 row g, k t; a1 row
  // g + 8; a2 and a3 at k t + 4), straight from device memory, scaled first
  float qf[F32 ? D / 8 : 1][4];
  if constexpr (F32) {
    const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * warp + g + 8 * hh;
      const float* qr = qg + (row < a.L ? row : 0) * a.sq[2] + t;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        qf[ks][hh] = row < a.L ? __ldg(qr + 8 * ks) * a.scale : 0.f;
        qf[ks][2 + hh] = row < a.L ? __ldg(qr + 8 * ks + 4) * a.scale : 0.f;
      }
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  if constexpr (!F32) mbar_wait(qbar, 0);

  for (int i = 0; tile < a.ntiles; ++i) {
    if (ahead < a.ntiles) {  // into the slot of the tile before this one
      if (leader) load_kv(issued, ahead);
      ++issued;
      ahead = next_tile(flags, ahead + 1, a.ntiles, skip);
    }
    __syncwarp();
    const TileMask tm = tile_mask(mrow, tile * kBK, a.L);
    mbar_wait(bars + 8 * (i % S), (i / S) & 1);
    const uint32_t k_s = base + G::kRing + 2 * (i % S) * G::kTile;
    const uint32_t v_s = k_s + G::kTile;

    fence_regs(s);
    if constexpr (F32) {
      split_kv<D>(sbase + (k_s - base), sbase + (v_s - base), sbase + G::kVtHi, sbase + G::kVtLo);
      // S = q k^T in three TF32 products per 8-column step: 32 bytes along the swizzled rows
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(qf[ks][r], ahi[r], alo[r]);
        const uint32_t off = (ks / 4) * G::kBoxBytes + (ks % 4) * 32;
        const uint64_t khi = smem_desc(k_s + off, 16, 1024, 1);
        const uint64_t klo = smem_desc(v_s + off, 16, 1024, 1);  // k's low parts, in the v slot
        wgmma_m64n64k8_tf32(s, alo, khi, ks > 0);
        wgmma_m64n64k8_tf32(s, ahi, klo, 1);
        wgmma_m64n64k8_tf32(s, ahi, khi, 1);
      }
    } else {
      // S = q k^T: a k16 step is 32 bytes along the swizzled rows, in the next box past kBoxD
      constexpr uint32_t kSbo = 8 * G::kRowBytes;  // 8-row groups of the swizzle
      const uint32_t q_s = base + wg * G::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / G::kBoxD) * G::kBoxBytes + (kk * 16 % G::kBoxD) * 2;
        wgmma_m64n64k16_ss(s, smem_desc(q_s + off, 16, kSbo, G::kSwizzle),
                           smem_desc(k_s + off, 16, kSbo, G::kSwizzle), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    online_softmax(s, tm, F32 ? 1.0f : a.scale, m, l, alpha);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    fence_regs(o);
    if constexpr (F32) {
      // O += P v in 8-key steps: step kk's k index t is key 8 kk + 2t and t + 4
      // is key 8 kk + 2t + 1 (v^T's keys were stored in that order), so the
      // A fragment is this thread's own probabilities
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t phi[4], plo[4];
        split_tf32(s[4 * kk + 0], phi[0], plo[0]);
        split_tf32(s[4 * kk + 2], phi[1], plo[1]);
        split_tf32(s[4 * kk + 1], phi[2], plo[2]);
        split_tf32(s[4 * kk + 3], phi[3], plo[3]);
        const uint32_t off = (kk / 4) * G::kVtBox + (kk % 4) * 32;
        const uint64_t vhi = smem_desc(base + G::kVtHi + off, 16, 1024, 1);
        const uint64_t vlo = smem_desc(base + G::kVtLo + off, 16, 1024, 1);
        wgmma_pv_tf32<D>(o, plo, vhi);
        wgmma_pv_tf32<D>(o, phi, vlo);
        wgmma_pv_tf32<D>(o, phi, vhi);
      }
    } else {
      // P as A fragments, k16 step kk: keys 16 kk .. 16 kk + 15 are accumulator chunks 2 kk and 2 kk + 1
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P v: v MN-major (rows of keys, D contiguous); a k16 step is 16 rows
      constexpr uint32_t kSbo = 8 * G::kRowBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<D>(o, p[kk], smem_desc(v_s + kk * 16 * G::kRowBytes, G::kBoxBytes, kSbo, G::kSwizzle));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (F32) {
      __syncthreads();  // the block is done with this slot and v^T before they are written again
    } else {  // each warp releases the slot; the warpgroups run on without waiting for each other
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(bars + 8 * (S + i % S));
    }
    tile = next_tile(flags, tile + 1, a.ntiles, skip);
  }

  // o[4j + 2hh + c] is row g + 8hh of the warp's 16, column 8j + 2t + c
  const int HD = a.H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * warp + g + 8 * hh;
    if (row >= a.L) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    T* dst = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.L + row) * HD + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = o[4 * j + 2 * hh] / denom, x1 = o[4 * j + 2 * hh + 1] / denom;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// an operand [B, H, L, D] with element strides s over (b, h, l), read in
// boxes of kBoxD values x 64 rows of one (b, h); the dimensions after D go in
// the order of their strides, (L, H, B) when l_first, else (H, L, B)
template <typename T, int D>
bool tensor_map(CUtensorMap* map, const void* ptr, const long long* s, int B, int H, int L, bool l_first) {
  using G = Geometry<T, D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(l_first ? L : H),
                              static_cast<cuuint64_t>(l_first ? H : L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>((l_first ? s[2] : s[1]) * sizeof(T)),
                                 static_cast<cuuint64_t>((l_first ? s[1] : s[2]) * sizeof(T)),
                                 static_cast<cuuint64_t>(s[0] * sizeof(T))};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kBoxD), l_first ? 64u : 1u, l_first ? 1u : 64u, 1u};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, G::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(Args a, int B, cudaStream_t stream) {
  a.nqb = (a.L + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * a.H * a.nqb;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // each operand's map, its dimensions in the order of its strides (f32 reads q itself)
  const long long* s[3] = {a.sq, a.sk, a.sv};
  const void* p[3] = {a.q, a.k, a.v};
  CUtensorMap maps[3];
  int l_first = 0;
  for (int i = Geometry<T, D>::kF32 ? 1 : 0; i < 3; ++i) {
    const bool lf = s[i][2] <= s[i][1];
    l_first |= static_cast<int>(lf) << i;
    if (!tensor_map<T, D>(&maps[i], p[i], s[i], B, a.H, a.L, lf)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Geometry<T, D>::kF32) maps[0] = maps[1];  // unread
  const int smem = Geometry<T, D>::kSmem + a.ntiles * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<T, D><<<static_cast<int>(blocks), kThreads, smem, stream>>>(maps[0], maps[1], maps[2], a,
                                                                               l_first);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q, k, v [B, H, L, D], D contiguous, with element strides over (b, h, l) in
// strides[0:3], [3:6] and [6:9]; f32 (dtype 0) or bf16 (dtype 1); every base
// and stride a multiple of 16 bytes. mask [B, L] of bytes, nonzero = attend.
// out [B, L, H, D] contiguous, of q's dtype. All on the current device.
// Returns a cudaError_t: 0 when the launch was accepted.
int flash_attention_launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H,
                           int L, int D, int dtype, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || (D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  for (int i = 0; i < 9; ++i) {
    if (strides[i] < 0 || (strides[i] * elem) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const unsigned char*>(mask);
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
  }
  a.H = H;
  a.L = L;
  a.ntiles = (L + kBK - 1) / kBK;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 32) return launch<float, 32>(a, B, s);
    if (D == 64) return launch<float, 64>(a, B, s);
    return launch<float, 128>(a, B, s);
  }
  if (D == 32) return launch<__nv_bfloat16, 32>(a, B, s);
  if (D == 64) return launch<__nv_bfloat16, 64>(a, B, s);
  return launch<__nv_bfloat16, 128>(a, B, s);
}

}  // extern "C"
