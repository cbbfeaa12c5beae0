// K3 on Hopper: ColBERT MaxSim over a token-major corpus, on the bf16 tensor
// cores (wgmma) fed by TMA.
//
// Replaces the TPU kernel capreolus_tpu/ops/maxsim.py::_maxsim_kernel
// (launched by _maxsim_pallas). For query q, query token i, document c and
// document token k, with q [Q, Lq, dim] and docs [Ld, C, dim] in bf16, the
// additive mask bias [Ld, C] in f32 (0 valid, -1e9 masked) and valid [C]:
//   s(q, i, c, k) = sum_e f32(q[q, i, e]) * f32(docs[k, c, e])
//   out[q, c]     = sum_{i < Lq} max_{k < Ld, bias[k, c] >= 0} s(q, i, c, k)
//                   , -inf where valid[c] == 0
// A masked token never takes part in a max (it is skipped, not biased), so a
// valid document's score equals the Pallas kernel's and the searcher's XLA
// math, whose -1e9 bias can never win against a valid token. The product of
// two bf16 values is exact in f32, so the kernel differs from the plain
// version only in the order of its sums.
//
// What bounds it on an H100, at the served shapes (C = 20,000 docs of
// Ld = 180 tokens, dim = 128, Lq = 32): the corpus is 922 MB of bf16. One
// query does 29.5 GFLOP, so its bound is the corpus read once, 0.28 ms at
// 3.35 TB/s: the design streams it by TMA from enough blocks to keep the
// memory busy. 64 queries do 1.89 TFLOP, 1.9 ms on the dense bf16 tensor cores
// (28 ms at the 67 TFLOP/s f32 rate of the CUDA cores, which a design of f32
// FMAs cannot beat): the design runs the products on wgmma and reads each doc tile from
// device memory about once for all row groups. chip_smoke.py counts each
// bound from the run's mask; PERF.md has the times.
//
// Design. A block owns a tile of 64 docs, a group of query rows and a range
// of doc tokens; the launch plan (ops/maxsim.py::maxsim_plan) picks them and
// this file only checks it.
// - Rows: each consumer warpgroup holds 64 query rows as wgmma A fragments in
//   registers, loaded once: whole queries (64 / Lq of them) when Lq <= 64, so
//   that a query's sum stays inside the block; a query of more tokens is cut
//   into 64-row chunks, which the block's warpgroups take in passes over the
//   tokens, adding each pass's rows to a running sum in a fixed order.
// - Products: per doc token k, one wgmma.m64n64k16 per 16 dims of
//   [64 rows x dim] x [dim x 64 docs]: token k's doc tile [64, dim] is
//   contiguous and dim-major in the [Ld, C, dim] layout, so it is the
//   K-major B operand as stored. The f32 accumulators are masked by token
//   k's bias column and folded into running maxima held in registers.
// - Loads: a producer warp keeps token tiles in flight through a ring of
//   mbarrier-tracked stages: the doc tile by TMA (3-D map over (dim, C, Ld),
//   128-byte swizzle, zero fill past C and past dim) and the tile's bias
//   column by cp.async (zero fill past C; those docs are never written). A
//   dim that is not a multiple of 8 cannot be described to TMA (its row
//   stride is not a multiple of 16 bytes): then the same warp stores the
//   tile, zero-padded, into the same swizzled layout with plain loads.
// - Reuse at 64 queries: a block runs three consumer warpgroups (192 rows)
//   on each B tile it loads (one when a single warpgroup holds every row), and the blocks of one doc tile's row
//   groups have adjacent indices, so they run together and read the tile
//   from L2 after the first. With three, one warpgroup's mask-and-max runs
//   while the others' products keep the tensor cores busy.
// - One query fills the card: its 313 doc tiles are too few blocks for 132
//   SMs, so the plan splits Ld into ranges, one block each, launched as a
//   thread-block cluster; partial maxima combine by max through distributed
//   shared memory (max is exact, so the split changes no bit), and no second
//   launch or workspace is needed.
// - The end: each warpgroup writes its row maxima to shared memory; after a
//   cluster barrier each block of the cluster takes a share of the 64 docs,
//   takes the max over the cluster's blocks in rank order and adds each
//   query's rows in ascending order. Nothing is atomic: results are
//   bit-identical from run to run.

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBC = 64;         // docs per tile: the wgmma N
constexpr int kRows = 64;       // query rows per consumer warpgroup: the wgmma M
constexpr int kMaxDim = 128;
constexpr int kKSteps = kMaxDim / 16;    // 16-dim steps of a product: dims past dim are zeros in A and B
constexpr int kBoxes = kMaxDim / 64;     // 64-dim TMA boxes of a doc tile (past dim: zero-filled)
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr uint32_t kBoxBytes = kBC * 128;  // 64 docs x 64 dims of bf16, one 128-byte swizzle row each
constexpr uint32_t kFullArrivals = 33;     // the TMA issuer's arrival, then one per producer lane (cp.async)

struct Args {
  const unsigned short* q;     // [Q * Lq, dim] bf16 bits
  const unsigned short* docs;  // [Ld, C, dim] bf16 bits
  const float* bias;           // [Ld, C]
  const unsigned char* valid;  // [C]
  float* out;                  // [Q, C]
  int Q, Lq, Ld, C, dim;
  int qw;      // whole queries per warpgroup (Lq <= 64), else 1
  int chunks;  // 64-row chunks of a query (Lq > 64), else 1
  int passes;  // passes over the tokens: ceil(chunks / W)
  int groups;  // row groups per doc tile
  int splits;  // token ranges per (doc tile, row group): the cluster size
};

// Shared memory of a block with W consumer warpgroups: the ring of doc tiles
// (1024-byte aligned for the swizzle), the ring's bias columns, the row
// maxima, a query's running sums (chunked queries), then full[S] and empty[S].
template <int W>
struct Geometry {
  static constexpr int kStages = W == 1 ? 5 : 8;  // W = 1: two blocks per SM
  static constexpr int kThreads = 128 * W + 32;   // the consumers, then the producer warp
  static constexpr uint32_t kStage = 2 * kBoxBytes;
  static constexpr uint32_t kBias = kStages * kStage;
  static constexpr uint32_t kRed = kBias + kStages * kBC * 4;
  static constexpr uint32_t kSum = kRed + W * kRows * kBC * 4;
  static constexpr uint32_t kBars = kSum + kBC * 4;
  static constexpr int kSmem = 1024 + kBars + 16 * kStages;
};

// d[64 x 64] (+)= a[64 x 16] * b[64 x 16]^T: a in registers (bf16 pairs), b
// K-major in shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 4 bytes from global to shared memory, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// the barrier counts one arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The flattened query row (q * Lq + i) of row r of warpgroup w's tile in
// pass p, or -1 for a row that holds no query token (its A rows are zero).
__device__ __forceinline__ long long query_row(const Args& a, int group, int W, int w, int p, int r) {
  if (a.chunks == 1) {
    const int query = (group * W + w) * a.qw + r / a.Lq;
    if (r >= a.qw * a.Lq || query >= a.Q) return -1;
    return static_cast<long long>(query) * a.Lq + r % a.Lq;
  }
  const int i = (p * W + w) * kRows + r;
  return i < a.Lq ? static_cast<long long>(group) * a.Lq + i : -1;
}

// W: 1 or 3 consumer warpgroups; kTma: TMA loads (dim a multiple of 8) or plain ones
template <int W, bool kTma>
__global__ void __launch_bounds__(Geometry<W>::kThreads, W == 1 ? 2 : 1)
    maxsim_kernel(const __grid_constant__ CUtensorMap map_d, const Args a) {
  using G = Geometry<W>;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + G::kBars;  // full[S], then empty[S]
  float* const bias_s = reinterpret_cast<float*>(sbase + G::kBias);
  float* const red = reinterpret_cast<float*>(sbase + G::kRed);
  float* const sum_s = reinterpret_cast<float*>(sbase + G::kSum);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x % a.splits;  // the block's rank in its cluster
  const int group = (blockIdx.x / a.splits) % a.groups;
  const int c0 = blockIdx.x / a.splits / a.groups * kBC;
  const int nc = min(kBC, a.C - c0);
  const int k_lo = static_cast<int>(static_cast<long long>(split) * a.Ld / a.splits);
  const int ntok = static_cast<int>(static_cast<long long>(split + 1) * a.Ld / a.splits) - k_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // W: the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, kFullArrivals);
      mbar_init(bars + 8 * (S + s), 4 * W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int p = 0; p < a.passes; ++p) {
    if (wg == W) {
      // ---------------------------------------------------------- producer
      for (int t = 0; t < ntok; ++t) {
        const int n = p * ntok + t, slot = n % S, k = k_lo + t;
        if (n >= S) mbar_wait(bars + 8 * (S + slot), (n / S + 1) & 1);  // the consumers released it
        const uint32_t full = bars + 8 * slot;
        const uint32_t dst = base + slot * G::kStage;
        if constexpr (kTma) {
          if (lane == 0) {
            mbar_expect_tx(full, kBoxes * kBoxBytes);  // zero-filled bytes count too
            for (int x = 0; x < kBoxes; ++x) tma_load(dst + x * kBoxBytes, &map_d, full, 64 * x, c0, k);
          }
        } else {
          // 16-byte chunks (8 dims) of the tile, zero past dim and past C, in TMA's swizzle
          uint8_t* const tile = sbase + slot * G::kStage;
          for (int idx = lane; idx < kBoxes * kBC * 8; idx += 32) {
            const int x = idx / (kBC * 8), j = idx / 8 % kBC, c = idx % 8;
            const int e0 = 64 * x + 8 * c;
            unsigned short h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            if (j < nc) {
              const unsigned short* src = a.docs + (static_cast<size_t>(k) * a.C + c0 + j) * a.dim;
              for (int u = 0; u < 8 && e0 + u < a.dim; ++u) h[u] = __ldg(src + e0 + u);
            }
            const uint4 v = make_uint4(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                                       h[2] | (static_cast<uint32_t>(h[3]) << 16),
                                       h[4] | (static_cast<uint32_t>(h[5]) << 16),
                                       h[6] | (static_cast<uint32_t>(h[7]) << 16));
            *reinterpret_cast<uint4*>(tile + x * kBoxBytes + j * 128 + ((c ^ (j % 8)) * 16)) = v;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, to wgmma's reads
          __syncwarp();
          if (lane == 0) mbar_arrive(full);
        }
        // the token's bias column
        for (int j = lane; j < kBC; j += 32) {
          const float* src = a.bias + static_cast<size_t>(k) * a.C + c0 + min(j, nc - 1);
          cp_async4(smem_u32(bias_s + slot * kBC + j), src, j < nc ? 4u : 0u);
        }
        cp_async_arrive(full);
      }
      __syncwarp();
    } else {
      // ---------------------------------------------------------- consumers
      // this thread's accumulator rows r0 and r0 + 8 of the warpgroup's 64;
      // columns 8j + 2t and 8j + 2t + 1
      const int r0 = (warp % 4) * 16 + lane / 4, t4 = lane % 4;
      // A fragments: a0 (row r0, dims 2t..2t+1), a1 (r0 + 8), a2 and a3 at dims + 8, per 16-dim step
      uint32_t afr[kKSteps][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = query_row(a, group, W, wg, p, r0 + 8 * hh);
        const unsigned short* qr = a.q + (row < 0 ? 0 : row) * a.dim;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 16 * kk + 8 * half + 2 * t4;
            const uint32_t lo = row >= 0 && e < a.dim ? __ldg(qr + e) : 0u;
            const uint32_t hi = row >= 0 && e + 1 < a.dim ? __ldg(qr + e + 1) : 0u;
            afr[kk][hh + 2 * half] = lo | (hi << 16);
          }
        }
      }
      float m[32], acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        m[i] = -INFINITY;
        acc[i] = 0.f;
      }
      for (int t = 0; t < ntok; ++t) {
        const int n = p * ntok + t, slot = n % S;
        mbar_wait(bars + 8 * slot, (n / S) & 1);
        const uint32_t b_s = base + slot * G::kStage;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          wgmma_m64n64k16_rs(acc, afr[kk], smem_desc(b_s + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024, 1),
                             kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        float2 bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(bias_s + slot * kBC + 8 * j + 2 * t4);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (S + slot));  // the stage is free for the producer
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool ok = (c ? bv[j].y : bv[j].x) >= 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              m[4 * j + 2 * h + c] = fmaxf(m[4 * j + 2 * h + c], ok ? acc[4 * j + 2 * h + c] : -INFINITY);
            }
          }
        }
      }
      float* const mine = red + (wg * kRows) * kBC;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(mine + (r0 + 8 * h) * kBC + 8 * j + 2 * t4) =
              make_float2(m[4 * j + 2 * h], m[4 * j + 2 * h + 1]);
        }
      }
    }

    // ------------------------------------------------------------ combine
    cluster.sync();  // every block's row maxima are written
    const int j_lo = split * kBC / a.splits, ncols = (split + 1) * kBC / a.splits - j_lo;
    const float* rows_s = red;  // the row maxima this block sums, over its share of the docs
    if (a.splits > 1) {
      // the max over the cluster's blocks, into this block's ring, idle now (splits > 1: one pass)
      const float* parts[kMaxSplits];
      for (int s = 0; s < a.splits; ++s) parts[s] = cluster.map_shared_rank(red, s);
      float* const mx = reinterpret_cast<float*>(sbase);
      for (int idx = threadIdx.x; idx < W * kRows * ncols; idx += G::kThreads) {
        const int at = idx / ncols * kBC + j_lo + idx % ncols;
        float v = parts[0][at];
#pragma unroll
        for (int s = 1; s < kMaxSplits; ++s) {
          if (s < a.splits) v = fmaxf(v, parts[s][at]);
        }
        mx[at] = v;
      }
      __syncthreads();
      rows_s = mx;
    }
    const int slots = a.chunks == 1 ? W * a.qw : 1;  // queries of the block
    for (int idx = threadIdx.x; idx < slots * ncols; idx += G::kThreads) {
      const int j = j_lo + idx % ncols, qs = idx / ncols;
      float sum;
      int query;
      if (a.chunks == 1) {
        const int w = qs / a.qw, qq = qs % a.qw;
        query = (group * W + w) * a.qw + qq;
        if (query >= a.Q) continue;
        sum = 0.f;
        for (int r = qq * a.Lq; r < (qq + 1) * a.Lq; ++r) sum += rows_s[(w * kRows + r) * kBC + j];
      } else {  // one query, one block: this pass's chunks, in order
        query = group;
        sum = p == 0 ? 0.f : sum_s[j];
        for (int w = 0; w < W; ++w) {
          for (int r = 0; r < kRows && (p * W + w) * kRows + r < a.Lq; ++r) sum += rows_s[(w * kRows + r) * kBC + j];
        }
        sum_s[j] = sum;
        if (p + 1 < a.passes) continue;
      }
      if (j < nc) a.out[static_cast<size_t>(query) * a.C + c0 + j] = a.valid[c0 + j] ? sum : -INFINITY;
    }
    cluster.sync();  // the maxima are read before they are written again or the blocks exit
  }
}

template <int W, bool kTma>
int launch(const CUtensorMap& map, const Args& a, int blocks, cudaStream_t stream) {
  using G = Geometry<W>;
  cudaError_t err = cudaFuncSetAttribute(maxsim_kernel<W, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, maxsim_kernel<W, kTma>, map, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest dim the kernel takes.
int maxsim_max_dim() { return kMaxDim; }

// q [Q, Lq, dim] bf16, docs [Ld, C, dim] bf16 (16-byte aligned), bias [Ld, C]
// f32, valid [C] bytes, out [Q, C] f32; all contiguous on the current device.
// plan = {W, qw, chunks, passes, groups, splits} from ops/maxsim.py::
// maxsim_plan, checked here to cover every (query row, doc, doc token) once.
// Returns a cudaError_t: 0 when the launch was accepted.
int maxsim_launch(const void* q, const void* docs, const void* bias, const void* valid, void* out, int Q,
                  int Lq, int Ld, int C, int dim, const int* plan, void* stream) {
  if (Q <= 0 || Lq <= 0 || Ld <= 0 || C <= 0 || dim <= 0 || dim > kMaxDim ||
      reinterpret_cast<uintptr_t>(docs) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const unsigned short*>(q);
  a.docs = static_cast<const unsigned short*>(docs);
  a.bias = static_cast<const float*>(bias);
  a.valid = static_cast<const unsigned char*>(valid);
  a.out = static_cast<float*>(out);
  a.Q = Q;
  a.Lq = Lq;
  a.Ld = Ld;
  a.C = C;
  a.dim = dim;
  const int W = plan[0];
  a.qw = plan[1];
  a.chunks = plan[2];
  a.passes = plan[3];
  a.groups = plan[4];
  a.splits = plan[5];
  const bool rows_ok = Lq <= kRows
                           ? a.chunks == 1 && a.qw >= 1 && a.qw * Lq <= kRows &&
                                 static_cast<long long>(a.groups) * W * a.qw >= Q && a.passes == 1
                           : a.qw == 1 && a.chunks == (Lq + kRows - 1) / kRows && a.groups == Q &&
                                 a.passes == (a.chunks + W - 1) / W && a.splits == 1;
  const long long blocks = static_cast<long long>((C + kBC - 1) / kBC) * a.groups * a.splits;
  if ((W != 1 && W != 3) || !rows_ok || a.splits < 1 || a.splits > kMaxSplits || a.splits > Ld ||
      blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap map = {};
  const bool tma = dim % 8 == 0;
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(Ld)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dim) * 2, static_cast<cuuint64_t>(C) * dim * 2};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kBC), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(docs), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int nb = static_cast<int>(blocks);
  if (W == 1) return tma ? launch<1, true>(map, a, nb, s) : launch<1, false>(map, a, nb, s);
  return tma ? launch<3, true>(map, a, nb, s) : launch<3, false>(map, a, nb, s);
}

}  // extern "C"
