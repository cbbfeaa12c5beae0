// K3 on Hopper: ColBERT MaxSim over a token-major corpus.
//
// Replaces the TPU kernel capreolus_tpu/ops/maxsim.py::_maxsim_kernel
// (launched by _maxsim_pallas). For query q, query token i, document c and
// document token k, with q [Q, Lq, dim] and docs [Ld, C, dim] in bf16, the
// additive mask bias [Ld, C] in f32 (0 valid, -1e9 masked) and valid [C]:
//   s(q, i, c, k) = sum_e f32(q[q, i, e]) * f32(docs[k, c, e])   (f32 FMAs)
//   out[q, c]     = sum_{i < Lq} max_{k < Ld, bias[k, c] >= 0} s(q, i, c, k)
//                   , -inf where valid[c] == 0
// A masked token never takes part in a max (it is skipped, not biased), so a
// valid document's score equals the Pallas kernel's and the searcher's XLA
// math, whose -1e9 bias can never win against a valid token.
//
// Numerics: bf16 is widened to f32 on its way into shared memory and every
// product is an f32 FMA. The product of two bf16 values is exact in f32, so the
// kernel differs from a bf16-in / f32-accumulate dot only in the order of its
// sums. The sum over query tokens runs in ascending i in one thread, with no
// atomics: results are bit-identical from run to run.
//
// What bounds it on an H100: at the served shapes (C = 20,000 docs of
// Ld = 180 tokens, dim = 128, Lq = 32) the corpus is 922 MB of bf16. One query
// (Q = 1) does 29.5 GFLOP, so its bound is the corpus read once, 0.28 ms at
// 3.35 TB/s; 64 queries do 1.89 TFLOP, 1.9 ms on the bf16 tensor cores and
// 28 ms at the card's 67 TFLOP/s f32 rate outside them, which this kernel
// uses. chip_smoke.py counts the bound from each run's mask.
//
// Design, simple and right first. The Pallas kernel walks doc blocks in order
// on one core; here a block owns (a group of whole queries, a tile of BC
// docs), and blocks run in parallel on the 132 SMs. For each doc token k the
// block streams the tile's k-th token embeddings ([BC, dim], contiguous in the
// [Ld, C, dim] layout) into shared memory, transposed to [dim][BC] f32, while
// the query rows sit in shared memory as [dim][BR] f32. Each thread owns an
// RQ x 4 register tile of (query token, doc) pairs: per k it forms the RQ x 4
// dot products from float4 loads (query rows broadcast within a warp, docs
// contiguous, so no bank conflicts) and folds them into running maxima held in
// registers. The next token's tile is loaded into registers while the current
// one is computed. Only the [Q, C] scores reach device memory: the
// [Q, Lq, C, Ld] similarity tensor of the XLA path never exists.
//
// A block of consecutive linear ids shares one doc tile across its query
// groups, so at Q = 64 the tile is read from device memory about once and
// then from L2. Ragged edges are masked in the kernel, not padded by the
// caller: any Q, Lq, Ld, C >= 1 and 1 <= dim <= 128 (a dim that is not a
// multiple of 8 takes scalar loads; zero-filled dims add exact zeros). A query
// with more than BR tokens is processed in chunks of BR rows, each streaming
// the tile's tokens again and adding its rows' maxima in order.
//
// Left for later work: bf16 tensor cores (wgmma) with TMA loads, and splitting
// Ld across blocks so that a single query fills more of the card.

#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 128;
constexpr int kRC = 4;  // docs per thread

__device__ __forceinline__ float bf16_bits_to_float(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[2 * t] = __uint_as_float(w[t] << 16);
    v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
  }
}

// TY x TX threads; each owns RQ query rows x kRC docs. BR = TY * RQ rows,
// BC = TX * kRC docs per block.
template <int TY, int TX, int RQ>
struct Tile {
  static constexpr int kThreads = TY * TX;
  static constexpr int kBR = TY * RQ;
  static constexpr int kBC = TX * kRC;
  // 16-byte chunks of one doc token's tile per thread, at dim = 128
  static constexpr int kLoads = (kBC * (kMaxDim / 8) + kThreads - 1) / kThreads;
};

struct Args {
  const unsigned short* q;     // [Q, Lq, dim] bf16 bits
  const unsigned short* docs;  // [Ld, C, dim] bf16 bits
  const float* bias;           // [Ld, C]
  const unsigned char* valid;  // [C]
  float* out;                  // [Q, C]
  int Q, Lq, Ld, C, dim;
  int dimp;     // dim rounded up to 8
  int qb;       // whole queries per block
  int chunks;   // row chunks per query group
  int groups;   // query groups
  int vec;      // 16-byte loads of the corpus
};

template <int TY, int TX, int RQ>
__global__ void __launch_bounds__(TY* TX, (TY * TX >= 256) ? 2 : 4) maxsim_kernel(Args a) {
  using T = Tile<TY, TX, RQ>;
  constexpr int BR = T::kBR, BC = T::kBC, NT = T::kThreads, NL = T::kLoads;
  extern __shared__ float smem[];
  const int qrows = a.dimp > BC ? a.dimp : BC;  // the q tile and the maxima share this space
  float* q_s = smem;                             // [dimp][BR], then maxima [BR][BC]
  float* red_s = smem;
  float* d_s = q_s + qrows * BR;                 // [dimp][BC]
  float* acc_s = d_s + a.dimp * BC;              // [qb][BC] running sums over query tokens
  int* flag_s = reinterpret_cast<int*>(acc_s + a.qb * BC);  // [BC] token k valid for doc j

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int group = blockIdx.x % a.groups;
  const int tile = blockIdx.x / a.groups;
  const int c0 = tile * BC;
  const int nc = min(BC, a.C - c0);
  const int q0 = group * a.qb;                   // first query of the group
  const int group_rows = a.qb * a.Lq;
  const int row0 = q0 * a.Lq;                    // first flattened query row of the group
  const int total_rows = a.Q * a.Lq;
  const int dchunks = a.dimp / 8;

  uint4 stage[NL];
  int stage_flag = 0;

  // the k-th token's tile into registers: chunk idx -> doc j = idx % BC, dims 8 * (idx / BC)
  auto fetch = [&](int k) {
#pragma unroll
    for (int it = 0; it < NL; ++it) {
      const int idx = tid + it * NT;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      const int j = idx % BC, e0 = (idx / BC) * 8;
      if (idx < BC * dchunks && j < nc) {
        const unsigned short* src = a.docs + (static_cast<size_t>(k) * a.C + c0 + j) * a.dim + e0;
        if (a.vec) {
          raw = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          unsigned short h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          for (int t = 0; t < 8 && e0 + t < a.dim; ++t) h[t] = __ldg(src + t);
          memcpy(&raw, h, sizeof(raw));
        }
      }
      stage[it] = raw;
    }
    if (tid < BC) {
      stage_flag = tid < nc && __ldg(a.bias + static_cast<size_t>(k) * a.C + c0 + tid) >= 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int it = 0; it < NL; ++it) {
      const int idx = tid + it * NT;
      if (idx < BC * dchunks) {
        const int j = idx % BC, e0 = (idx / BC) * 8;
        float v[8];
        unpack8(stage[it], v);
#pragma unroll
        for (int t = 0; t < 8; ++t) d_s[(e0 + t) * BC + j] = v[t];
      }
    }
    if (tid < BC) flag_s[tid] = stage_flag;
  };

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    const int crow0 = chunk * BR;  // first row of this chunk inside the group
    // query rows of the chunk, transposed; rows past the group or past Q are zero
    for (int idx = tid; idx < BR * a.dimp; idx += NT) {
      const int r = idx % BR, e = idx / BR;
      const int gr = crow0 + r;
      float v = 0.f;
      if (gr < group_rows && row0 + gr < total_rows && e < a.dim) {
        v = bf16_bits_to_float(a.q[static_cast<size_t>(row0 + gr) * a.dim + e]);
      }
      q_s[e * BR + r] = v;
    }
    fetch(0);
    __syncthreads();  // q tile written
    store();
    __syncthreads();

    float m[RQ][kRC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) m[i][j] = -INFINITY;

    for (int k = 0; k < a.Ld; ++k) {
      if (k + 1 < a.Ld) fetch(k + 1);
      float s[RQ][kRC];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < kRC; ++j) s[i][j] = 0.f;
      const float* qp = q_s + ty * RQ;
      const float* dp = d_s + tx * kRC;
#pragma unroll 4
      for (int e = 0; e < a.dimp; ++e) {
        float qv[RQ];
#pragma unroll
        for (int i4 = 0; i4 < RQ / 4; ++i4) {
          const float4 t = *reinterpret_cast<const float4*>(qp + e * BR + 4 * i4);
          qv[4 * i4] = t.x;
          qv[4 * i4 + 1] = t.y;
          qv[4 * i4 + 2] = t.z;
          qv[4 * i4 + 3] = t.w;
        }
        const float4 dv = *reinterpret_cast<const float4*>(dp + e * BC);
        const float dd[kRC] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) s[i][j] = fmaf(qv[i], dd[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        const bool ok = flag_s[tx * kRC + j] != 0;
#pragma unroll
        for (int i = 0; i < RQ; ++i) m[i][j] = fmaxf(m[i][j], ok ? s[i][j] : -INFINITY);
      }
      __syncthreads();  // every thread is done with d_s and flag_s of token k
      if (k + 1 < a.Ld) {
        store();
        __syncthreads();
      }
    }

    // the chunk's maxima, then each (query, doc) adds its rows in ascending order
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      *reinterpret_cast<float4*>(red_s + (ty * RQ + i) * BC + tx * kRC) =
          make_float4(m[i][0], m[i][1], m[i][2], m[i][3]);
    }
    __syncthreads();
    for (int p = tid; p < a.qb * BC; p += NT) {
      const int qq = p / BC, j = p % BC;
      const int lo = max(qq * a.Lq, crow0) - crow0;
      const int hi = min((qq + 1) * a.Lq, crow0 + BR) - crow0;
      float sum = chunk == 0 ? 0.f : acc_s[p];
      for (int r = lo; r < hi; ++r) sum += red_s[r * BC + j];
      acc_s[p] = sum;
    }
    __syncthreads();  // the maxima are read before the next chunk's q tile overwrites them
  }

  // each (query, doc) pair is owned by the same thread in every chunk
  for (int p = tid; p < a.qb * BC; p += NT) {
    const int q = q0 + p / BC, j = p % BC;
    if (q < a.Q && j < nc) {
      a.out[static_cast<size_t>(q) * a.C + c0 + j] = a.valid[c0 + j] ? acc_s[p] : -INFINITY;
    }
  }
}

template <int TY, int TX, int RQ>
int launch(Args a, cudaStream_t stream) {
  using T = Tile<TY, TX, RQ>;
  constexpr int BR = T::kBR, BC = T::kBC;
  a.qb = a.Lq >= BR ? 1 : BR / a.Lq;
  if (a.qb > a.Q) a.qb = a.Q;
  a.chunks = (a.qb * a.Lq + BR - 1) / BR;
  a.groups = (a.Q + a.qb - 1) / a.qb;
  const long long tiles = (a.C + BC - 1) / BC;
  const long long blocks = tiles * a.groups;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int qrows = a.dimp > BC ? a.dimp : BC;
  const size_t smem = sizeof(float) * (static_cast<size_t>(qrows) * BR + static_cast<size_t>(a.dimp) * BC +
                                       static_cast<size_t>(a.qb) * BC) + sizeof(int) * BC;
  cudaError_t err = cudaFuncSetAttribute(maxsim_kernel<TY, TX, RQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  maxsim_kernel<TY, TX, RQ><<<static_cast<unsigned int>(blocks), T::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest dim the kernel takes.
int maxsim_max_dim() { return kMaxDim; }

// q [Q, Lq, dim] bf16, docs [Ld, C, dim] bf16, bias [Ld, C] f32, valid [C] bytes,
// out [Q, C] f32; all contiguous on the current device. Returns a cudaError_t:
// 0 when the launch was accepted.
int maxsim_launch(const void* q, const void* docs, const void* bias, const void* valid, void* out, int Q,
                  int Lq, int Ld, int C, int dim, void* stream) {
  if (Q <= 0 || Lq <= 0 || Ld <= 0 || C <= 0 || dim <= 0 || dim > kMaxDim) {
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
  a.dimp = (dim + 7) / 8 * 8;
  a.vec = dim % 8 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // fewer than 128 query rows: 32-row blocks, so that a single query wastes no row
  if (static_cast<long long>(Q) * Lq < 128) return launch<8, 16, 4>(a, s);
  return launch<16, 16, 8>(a, s);
}

}  // extern "C"
