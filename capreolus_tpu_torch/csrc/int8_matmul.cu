// X1/X2 on Hopper: an int8 x int8 -> int32 matrix product on the int8 tensor
// cores (wgmma), fed by TMA, with three epilogues.
//
// Replaces the TPU kernel scripts/exp_pallas_int8.py::matmul_kernel (X1,
// launched by pallas_int8_mm) and its twin scripts/exp_pallas_int8b.py::
// matmul_kernel (X2: the same body and BlockSpecs, timed R calls per
// dispatch). For a [M, K] and w [N, K], both int8 and K-contiguous (torch's
// Linear layout), the product acc[m, n] = sum_k int32(a[m, k]) * int32(w[n, k])
// is exact for the full int8 range, -128 included: |acc| <= K * 2^14 < 2^31
// for K < 2^17, which the binding checks. One kernel body, three epilogues:
//   int32:     out[m, n] = acc                                           (int32)
//   f32:       out = ((float(acc) * xs[m]) * ws[n]) + bias[n], xs optional (f32),
//              four separately rounded operations, as Int8Linear.forward runs
//              them in torch (the intrinsics below keep nvcc from fusing them)
//   int8-gelu: code = clamp(rint(gelu(v) / s[n]), -127, 127), v as in f32 (int8),
//              tanh or erf GELU written as torch's CUDA GELU writes it, the
//              division correctly rounded (Markstein's correction of a product
//              with the correctly rounded reciprocal: no slow-path call, which
//              cost this epilogue a third of its time)
// so that monoBERT's int8 layer never writes an int32 or f32 intermediate.
//
// What bounds it on an H100: at the served monoBERT shapes (M = 409,600 token
// rows, K and N in {768, 3072}) the output is the largest stream in int32 and
// f32 mode: the 768 -> 768 projections move 1.57 GB against 0.48 TOP (0.47 ms
// by bytes at 3.35 TB/s, 0.24 ms by the 1,979 TOP/s dense int8 peak); the
// 3072 -> 768 down-projection is bound by operations (0.98 ms), and so is the
// up-projection in int8-gelu mode, whose 1-byte codes cut its bytes by four.
// ColBERT's products (K = 128) are bound by the int32 similarities they write.
// chip_smoke.py counts each bound.
//
// Design (the Pallas kernel holds a 512 x 512 output block and all of K in
// VMEM; here shared memory is a ring and the grid persistent):
// - one block per SM walks the 128 x BN output tiles (BN = 128 or 256), n
//   fastest, so the blocks in flight share their A rows and W stays in L2;
// - warpgroup 0 is the producer: one thread keeps TMA loads of A [128 x 128 B]
//   and W [BN x 128 B] slices in flight through a ring of kStages stages, each
//   with a "full" mbarrier (TMA completes its transaction bytes) and an
//   "empty" one (every consumer warp releases the stage). TMA writes the 128-byte
//   swizzle that wgmma's descriptors name, zero-fills rows past M or N and
//   bytes past K (adding exact zeros), and keeps running into the next tile
//   while the consumers store this one, so the epilogue overlaps the loads;
// - warpgroups 1 and 2 each own 64 rows of the tile and issue
//   wgmma.mma_async.m64n128k32.s32.s8.s8 (BN / 128 per k32 step) on the stage,
//   keeping one wgmma group in flight: a stage is released once the group after
//   it has been issued and the one that read it has completed;
// - the epilogue maps every accumulator register to its (m, n) by the wgmma m64
//   fragment layout and stores only rows < M and columns < N; there are no
//   atomics, so results are bit-identical between runs.
// TMA needs K % 16 == 0 and 16-byte-aligned operands; the binding makes a
// zero-padded aligned copy of an operand that breaks either (counted).
// Measured on an H100 (PERF.md): the int8-gelu epilogue, not the product, sets
// that mode's time, and it and the f32 epilogue run fastest at BN = 128, whose
// 64 accumulators per thread leave the epilogue's arithmetic room to
// interleave, the int32 product at BN = 256 (the binding picks the width by
// epilogue); a ping-pong variant, each warpgroup a 64-row tile of its own in
// turn, ran slower at every served shape.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;       // output rows per tile: two consumer warpgroups of 64
constexpr int kBK = 128;       // bytes (int8 values) of K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int kConsumerWarps = 8;
constexpr uint32_t kABytes = kBM * kBK;

enum Mode { kInt32 = 0, kF32 = 1, kGeluTanh = 2, kGeluErf = 3 };

struct Params {
  void* out;                // [M, N]: int32, f32 or int8 by mode
  const float* x_scales;    // [M] or null
  const float* w_scales;    // [N]
  const float* bias;        // [N]
  const float* out_scales;  // [N], int8-gelu modes
  int M, N;
  int tiles_n;  // column tiles
  int tiles;    // all tiles
  int kblocks;  // K slices of kBK bytes
};

constexpr int smem_bytes(int bn) { return kStages * (kBM + bn) * kBK + 2 * kStages * 8 + 1024; }

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc128(uint32_t addr) { return smem_desc(addr, 16, 1024, 1); }

// d[64 x 128] (+)= a[64 x 32] * w[128 x 32]^T; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]),
        "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// torch's CUDA GELU (ActivationGeluKernel.cu), in f32, written the same way
template <int MODE>
__device__ __forceinline__ float gelu(float x) {
  if (MODE == kGeluTanh) {
    constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    constexpr float kKappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  } else {
    constexpr float kAlpha = static_cast<float>(0.70710678118654752440);
    return x * 0.5f * (1.0f + erff(x * kAlpha));
  }
}

// f32 mode's value: each operation rounded on its own, in Int8Linear's order
__device__ __forceinline__ float dequant(int acc, float xs, bool has_xs, float ws, float b) {
  float v = __int2float_rn(acc);
  if (has_xs) v = __fmul_rn(v, xs);
  return __fadd_rn(__fmul_rn(v, ws), b);
}

// g / s rounded to nearest even, given r = RN(1 / s): q0 = RN(g r) is within an
// ulp of g / s, the remainder g - s q0 is exact through the FMA, and one more
// FMA rounds the quotient correctly (Markstein), bit for bit the IEEE division
// torch runs, outside overflow, where q0 is already infinite
__device__ __forceinline__ float div_rn(float g, float s, float r) {
  const float q0 = __fmul_rn(g, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, g), r, q0);
  return isinf(q0) ? q0 : q;
}

template <int MODE>
__device__ __forceinline__ int8_t gelu_code(float v, float s, float r) {
  const float q = rintf(div_rn(gelu<MODE>(v), s, r));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f)));
}

// wgmma m64nN accumulator layout: register j*4 + h*2 + c of thread t holds row
// (t / 32) * 16 + (t % 32) / 4 + 8 * h and column 8 * j + (t % 4) * 2 + c
template <int BN, int MODE>
__device__ __forceinline__ void epilogue(const Params& p, int (&acc)[BN / 128][64], int row0, int n0) {
  const int t = threadIdx.x % 128;
  const int rows[2] = {row0 + (t / 32) * 16 + (t % 32) / 4, row0 + (t / 32) * 16 + (t % 32) / 4 + 8};
  const bool even_n = (p.N & 1) == 0;  // a column pair is then aligned and wholly inside N when its first is
  const bool has_xs = p.x_scales != nullptr;
  float xs[2] = {1.0f, 1.0f};
  if (MODE != kInt32 && has_xs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) xs[h] = rows[h] < p.M ? p.x_scales[rows[h]] : 0.0f;
  }
#pragma unroll
  for (int sub = 0; sub < BN / 128; ++sub) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + sub * 128 + j * 8 + (t % 4) * 2;
      if (col >= p.N) continue;
      const bool second = col + 1 < p.N;
      float ws[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f}, os[2] = {1.0f, 1.0f}, rs[2] = {1.0f, 1.0f};
      if (MODE != kInt32) {
        ws[0] = p.w_scales[col];
        b[0] = p.bias[col];
        if (second) {
          ws[1] = p.w_scales[col + 1];
          b[1] = p.bias[col + 1];
        }
        if (MODE == kGeluTanh || MODE == kGeluErf) {
          os[0] = p.out_scales[col];
          if (second) os[1] = p.out_scales[col + 1];
          rs[0] = __frcp_rn(os[0]);
          rs[1] = __frcp_rn(os[1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rows[h];
        if (row >= p.M) continue;
        const int v0 = acc[sub][j * 4 + h * 2];
        const int v1 = acc[sub][j * 4 + h * 2 + 1];
        const size_t off = static_cast<size_t>(row) * p.N + col;
        if (MODE == kInt32) {
          int32_t* dst = static_cast<int32_t*>(p.out) + off;
          if (even_n) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          } else {
            dst[0] = v0;
            if (second) dst[1] = v1;
          }
        } else if (MODE == kF32) {
          const float f0 = dequant(v0, xs[h], has_xs, ws[0], b[0]);
          const float f1 = dequant(v1, xs[h], has_xs, ws[1], b[1]);
          float* dst = static_cast<float*>(p.out) + off;
          if (even_n) {
            *reinterpret_cast<float2*>(dst) = make_float2(f0, f1);
          } else {
            dst[0] = f0;
            if (second) dst[1] = f1;
          }
        } else {
          const int8_t c0 = gelu_code<MODE>(dequant(v0, xs[h], has_xs, ws[0], b[0]), os[0], rs[0]);
          const int8_t c1 = gelu_code<MODE>(dequant(v1, xs[h], has_xs, ws[1], b[1]), os[1], rs[1]);
          int8_t* dst = static_cast<int8_t*>(p.out) + off;
          if (even_n) {
            *reinterpret_cast<char2*>(dst) = make_char2(c0, c1);
          } else {
            dst[0] = c0;
            if (second) dst[1] = c1;
          }
        }
      }
    }
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                     const Params p) {
  constexpr int kNSub = BN / 128;
  constexpr uint32_t kWBytes = BN * kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t a_s = base;
  const uint32_t w_s = a_s + kStages * kABytes;
  const uint32_t bars = w_s + kStages * kWBytes;  // full[kStages], then empty[kStages]
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * kBM;
        const int n0 = (tile % p.tiles_n) * BN;
        for (int kb = 0; kb < p.kblocks; ++kb) {
          mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);  // the consumers have released the stage
          const uint32_t full = bars + 8 * stage;
          mbar_expect_tx(full, kABytes + kWBytes);  // zero-filled bytes count too
          tma_load(a_s + stage * kABytes, &map_a, full, kb * kBK, m0);
          tma_load(w_s + stage * kWBytes, &map_w, full, kb * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // rows [64 c, 64 c + 64) of each tile
    const int lane = threadIdx.x % 32;
    int acc[kNSub][64];
#pragma unroll
    for (int s = 0; s < kNSub; ++s)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[s][i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM;
      const int n0 = (tile % p.tiles_n) * BN;
      int prev = 0;
      for (int kb = 0; kb < p.kblocks; ++kb) {
        mbar_wait(bars + 8 * stage, phase);
#pragma unroll
        for (int s = 0; s < kNSub; ++s) fence_regs(acc[s]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          // a k32 step is 32 bytes further along the swizzled 128-byte rows
          const uint64_t da = desc128(a_s + stage * kABytes + c * 64 * kBK + kk * 32);
#pragma unroll
          for (int s = 0; s < kNSub; ++s) {
            const uint64_t db = desc128(w_s + stage * kWBytes + s * 128 * kBK + kk * 32);
            wgmma_m64n128k32(acc[s], da, db, (kb | kk) != 0);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int s = 0; s < kNSub; ++s) fence_regs(acc[s]);
        wgmma_wait<1>();  // the group before this one has read its stage
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (kStages + prev));
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < kNSub; ++s) fence_regs(acc[s]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + prev));
      epilogue<BN, MODE>(p, acc, m0 + 64 * c, n0);
    }
  }
}

// a [rows, K] int8 matrix, K-contiguous, read as boxes of [box_rows x kBK bytes]
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MODE>
int launch(const void* a, const void* w, const Params& p, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  if (!tensor_map(&map_a, a, M, K, kBM) || !tensor_map(&map_w, w, N, K, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(int8_gemm_kernel<BN, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(BN));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < sms ? p.tiles : sms;
  int8_gemm_kernel<BN, MODE><<<grid, kThreads, smem_bytes(BN), stream>>>(map_a, map_w, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_mode(int mode, const void* a, const void* w, const Params& p, int M, int N, int K, cudaStream_t s) {
  switch (mode) {
    case kInt32:
      return launch<BN, kInt32>(a, w, p, M, N, K, s);
    case kF32:
      return launch<BN, kF32>(a, w, p, M, N, K, s);
    case kGeluTanh:
      return launch<BN, kGeluTanh>(a, w, p, M, N, K, s);
    case kGeluErf:
      return launch<BN, kGeluErf>(a, w, p, M, N, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a [M, K] int8 and w [N, K] int8, contiguous and 16-byte aligned with
// K % 16 == 0, on the current device; out [M, N] int32 (mode 0), f32 (mode 1)
// or int8 (modes 2 tanh GELU, 3 erf GELU). x_scales [M] may be null; w_scales,
// bias [N] are read in modes 1-3, out_scales [N] in modes 2-3. tile_n is 128
// or 256. Returns a cudaError_t: 0 when the launch was accepted.
int int8_gemm_launch(const void* a, const void* w, void* out, int M, int N, int K, int mode, const void* x_scales,
                     const void* w_scales, const void* bias, const void* out_scales, int tile_n, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (mode != kInt32 && (w_scales == nullptr || bias == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == kGeluTanh || mode == kGeluErf) && out_scales == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_n != 128 && tile_n != 256) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_m = (static_cast<long long>(M) + kBM - 1) / kBM;
  const long long tiles_n = (static_cast<long long>(N) + tile_n - 1) / tile_n;
  if (tiles_m * tiles_n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = out;
  p.x_scales = static_cast<const float*>(x_scales);
  p.w_scales = static_cast<const float*>(w_scales);
  p.bias = static_cast<const float*>(bias);
  p.out_scales = static_cast<const float*>(out_scales);
  p.M = M;
  p.N = N;
  p.tiles_n = static_cast<int>(tiles_n);
  p.tiles = static_cast<int>(tiles_m * tiles_n);
  p.kblocks = (K + kBK - 1) / kBK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_n == 128 ? launch_mode<128>(mode, a, w, p, M, N, K, s) : launch_mode<256>(mode, a, w, p, M, N, K, s);
}

}  // extern "C"
