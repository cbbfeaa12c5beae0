// X1/X2 on Hopper: an int8 x int8 -> int32 matrix product on the int8 tensor cores.
//
// Replaces the TPU kernel scripts/exp_pallas_int8.py::matmul_kernel (X1,
// launched by pallas_int8_mm) and its twin scripts/exp_pallas_int8b.py::
// matmul_kernel (X2: the same body and BlockSpecs, timed R calls per
// dispatch). For a [M, K] and w [N, K], both int8 and K-contiguous (torch's
// Linear layout), it computes
//   out[m, n] = sum_k int32(a[m, k]) * int32(w[n, k])        (int32, exact)
// for the full int8 range, -128 included: |out| <= K * 2^14 < 2^31 for
// K < 2^17, which the binding checks.
//
// What bounds it on an H100: at the served monoBERT shapes (M = 409,600 token
// rows, K and N in {768, 3072}) the int32 output is the largest stream. The
// 768 -> 768 projections move 1.57 GB against 0.48 TOP (0.47 ms by bytes at
// 3.35 TB/s, 0.24 ms by the 1,979 TOP/s dense int8 peak); the 768 -> 3072
// up-projection is bound by bytes too (1.60 ms), the 3072 -> 768
// down-projection by operations (0.98 ms). chip_smoke.py counts each bound.
//
// Design, simple and right first. The Pallas kernel holds a 512 x 512 output
// block and the whole K dimension in VMEM; here a block of 8 warps owns a
// 128 x 128 output tile and walks K in steps of 64 bytes, double-buffered in
// shared memory through cp.async (16-byte copies where K is a multiple of 16
// and both operands are 16-byte aligned; byte loads with zero fill
// otherwise). Each warp computes a 64 x 32 sub-tile with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: both operands are
// K-contiguous, so every fragment register is one 32-bit shared-memory load
// (A row-major, B "col" = w's rows) and nothing is transposed. Shared rows
// are padded from 64 to 80 bytes, so the 8 rows of a fragment load land on 8
// distinct groups of banks. Ragged M, N and K are masked in the kernel: rows
// and columns past the edge load as zero (adding exact zeros) and are not
// stored. The int32 accumulators stay in registers until one masked store
// per element; there are no atomics, so results are bit-identical between
// runs.
//
// Left for later work: wgmma with TMA loads and a persistent tile scheduler,
// and fusing the dequantization (acc * x_scale * w_scale + bias) into the
// epilogue so that the int32 output never reaches device memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 64;   // bytes of K per stage
constexpr int kThreads = 256;
constexpr int kStride = kBK + 16;  // shared-memory bytes per tile row
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // m16 tiles per warp
constexpr int kNT = kWarpN / 8;   // n8 tiles per warp
constexpr int kChunks = kBM * kBK / 16 / kThreads;  // 16-byte chunks per thread per tile

static_assert(kBM == kBN, "load_tile serves both operands with one row count");
static_assert(kChunks * kThreads * 16 == kBM * kBK, "tile chunks must divide among the threads");

struct Args {
  const int8_t* a;  // [M, K]
  const int8_t* w;  // [N, K]
  int32_t* out;     // [M, N]
  int M, N, K;
  int vec;  // 16-byte cp.async loads
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [row0, row0 + kBM) x bytes [k0, k0 + kBK) of a K-contiguous int8
// matrix with `rows` rows into a shared tile; out-of-range bytes are zero
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int row0, int rows, int k0, int K,
                                          int vec, int tid) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (kBK / 16);
    const int c = (idx % (kBK / 16)) * 16;
    int8_t* d = dst + r * kStride + c;
    const int gr = row0 + r;
    const int gk = k0 + c;
    if (vec) {
      // K % 16 == 0, so a chunk that starts inside K lies wholly inside it
      if (gr < rows && gk < K) {
        cp_async16(d, src + static_cast<size_t>(gr) * K + gk);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      unsigned int v[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const unsigned char* s = reinterpret_cast<const unsigned char*>(src) + static_cast<size_t>(gr) * K;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          if (gk + t < K) v[t >> 2] |= static_cast<unsigned int>(s[gk + t]) << (8 * (t & 3));
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned int (&a)[4], const unsigned int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring columns of one output row
__device__ __forceinline__ void store_pair(const Args& p, int row, int col, int v0, int v1) {
  if (row >= p.M || col >= p.N) return;
  int32_t* dst = p.out + static_cast<size_t>(row) * p.N + col;
  if ((p.N & 1) == 0) {  // col is even, so the pair is 8-byte aligned and wholly inside N
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    dst[0] = v0;
    if (col + 1 < p.N) dst[1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(Args p) {
  __shared__ __align__(16) int8_t a_s[2][kBM * kStride];
  __shared__ __align__(16) int8_t w_s[2][kBN * kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * kWarpM;  // 2 x 4 warps over the 128 x 128 tile
  const int wn = (warp & 3) * kWarpN;
  const int g = lane >> 2;  // the fragment's row (A, C) or column (B) group
  const int t = lane & 3;   // the thread's place in its group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.K + kBK - 1) / kBK;
  load_tile(a_s[0], p.a, m0, p.M, 0, p.K, p.vec, tid);
  load_tile(w_s[0], p.w, n0, p.N, 0, p.K, p.vec, tid);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {  // the next stage streams in while this one is multiplied
      load_tile(a_s[cur ^ 1], p.a, m0, p.M, (kt + 1) * kBK, p.K, p.vec, tid);
      load_tile(w_s[cur ^ 1], p.w, n0, p.N, (kt + 1) * kBK, p.K, p.vec, tid);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest is complete: stage `cur` has landed
    __syncthreads();

    const int8_t* as = a_s[cur];
    const int8_t* ws = w_s[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned int af[kMT][4];
      unsigned int bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // A fragment: rows g and g + 8 of the m16 tile, bytes 4t..4t+3 and 16 + 4t..
        const int8_t* base = as + (wm + i * 16 + g) * kStride + kk + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned int*>(base);
        af[i][1] = *reinterpret_cast<const unsigned int*>(base + 8 * kStride);
        af[i][2] = *reinterpret_cast<const unsigned int*>(base + 16);
        af[i][3] = *reinterpret_cast<const unsigned int*>(base + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // B fragment: column g of the n8 tile (row g of w), bytes 4t..4t+3 and 16 + 4t..
        const int8_t* base = ws + (wn + j * 8 + g) * kStride + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned int*>(base);
        bf[j][1] = *reinterpret_cast<const unsigned int*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // every warp is done with stage `cur` before it is refilled
  }

  // C fragment: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int row = m0 + wm + i * 16 + g;
      const int col = n0 + wn + j * 8 + t * 2;
      store_pair(p, row, col, acc[i][j][0], acc[i][j][1]);
      store_pair(p, row + 8, col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

extern "C" {

// a [M, K] int8, w [N, K] int8, out [M, N] int32; all contiguous on the current
// device. Returns a cudaError_t: 0 when the launch was accepted.
int int8_matmul_launch(const void* a, const void* w, void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long mtiles = (static_cast<long long>(M) + kBM - 1) / kBM;
  const long long ntiles = (static_cast<long long>(N) + kBN - 1) / kBN;
  if (mtiles > 2147483647LL || ntiles > 65535LL) return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.out = static_cast<int32_t*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(mtiles), static_cast<unsigned int>(ntiles));
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
