// The int8 ColBERT engine's MaxSim epilogue on Hopper: one pass over X1's
// int32 similarities of a chunk of docs.
//
// No TPU kernel: the JAX searcher's int8 scorer asks its int8 dot for bf16
// (preferred_element_type) and leaves the mask, max and sum to XLA. The
// port's X1 writes a chunk's int32 similarities sim [nq*lq, c*ld]; torch then
// rounded them to bf16, masked them, took the max over doc tokens, the sum
// over query tokens and the two scale products
// (ops/maxsim_epilogue.py::maxsim_epilogue_plain), streaming the
// similarities through device memory four times. Here, for each query q and
// doc d of the chunk:
//   m[t] = max over d's valid tokens j of bf16_rn(f32(sim[q*lq + t, d*ld + j])),
//          and bf16(-1e9), the plain version's masked fill, where d has a masked token
//   s    = m[0..lq) summed in ops/maxsim.py::sum_query_tokens's pairwise tree
//   out[q, d] = (s * qscale[q]) * dscale[d], or -inf where d has no valid token
// with the plain version's bits: int32 -> f32 rounds to nearest as torch's cast
// (exact below 2^24, which int8 products of dim <= 1040 stay under), f32 ->
// bf16 to nearest even, the max is exact, and each add and product is rounded
// alone (__fadd_rn, __fmul_rn: nothing contracts).
//
// What bounds it on an H100: bytes. A masked token's similarity is never read
// (its bf16(-1e9) enters the max once per doc instead), so the kernel reads the
// similarities of valid tokens once and writes each score once: at the served
// chunk [2,048 x 65,520] (364 docs of 180 token slots, 72.6 valid on average)
// ~216 MB of the 537 MB X1 wrote, 0.065 ms at 3.35 TB/s, where the plain
// version moves 1.61 GB (12 bytes a similarity). Design: a block takes one query and a tile of 32
// docs, and finds each doc's range of valid tokens once from the mask. A warp
// takes 4 of the query's token rows, 8 lanes a row, and walks the tile's
// docs: a lane loads 16-byte vectors (4 tokens) of the doc's valid range in
// its row, two before it reduces them, and skips a vector with no valid token,
// so the 8 lanes of a row read 128 contiguous bytes and the four rows of a
// warp share the doc's range (no divergence between them). Each row's max
// reduces over its 8 lanes by shuffles into shared memory; then one thread a
// doc sums the lq maxima in the tree's order and writes the score. Where ld
// is off a multiple of 4, or a base off 16 bytes, the vectors hold 2 tokens
// or 1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kDocs = 32;      // docs of a block's tile
constexpr int kRowLanes = 8;   // lanes that share a token row
constexpr int kRowsPerWarp = 32 / kRowLanes;
constexpr int kUnroll = 2;     // vectors a lane loads before it reduces them
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_of(int x) {
  return __bfloat162float(__float2bfloat16_rn(__int2float_rn(x)));
}

// The V mask bytes of a vector as one word: token k is valid where byte k is nonzero.
template <int V>
__device__ __forceinline__ uint32_t mask_word(const uint8_t* m) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(m));
  } else if constexpr (V == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(m));
  } else {
    return __ldg(m);
  }
}

// V similarities, read once: a streaming load, kept out of the way of the mask in L1 and L2.
template <int V>
__device__ __forceinline__ void load_sims(const int* p, int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (V == 2) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    maxsim_epilogue_kernel(const int* __restrict__ sim, const uint8_t* __restrict__ mask,
                           const float* __restrict__ qscale, const float* __restrict__ dscale,
                           float* __restrict__ out, long long out_stride, int lq, int c, int ld, int tiles) {
  __shared__ int s_lo[kDocs], s_hi[kDocs], s_masked[kDocs];  // [lo, hi): the vectors holding a doc's valid tokens
  extern __shared__ float s_max[];                            // [lq][kDocs]: each row's max over each doc
  const int q = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * kDocs;
  const int nd = min(kDocs, c - d0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int d = warp; d < nd; d += kWarps) {
    const uint8_t* m = mask + static_cast<long long>(d0 + d) * ld;
    int first = ld, last = -1, masked = 0;
    for (int j = lane; j < ld; j += 32) {
      if (m[j]) {
        first = min(first, j);
        last = j;
      } else {
        masked = 1;
      }
    }
    first = __reduce_min_sync(kFull, first);
    last = __reduce_max_sync(kFull, last);
    masked = __any_sync(kFull, masked);
    if (lane == 0) {
      s_lo[d] = first / V;
      s_hi[d] = last < 0 ? 0 : last / V + 1;
      s_masked[d] = masked;
    }
  }
  __syncthreads();

  const float masked_fill = __bfloat162float(__float2bfloat16_rn(-1e9f));
  const long long row_len = static_cast<long long>(c) * ld;
  const int g = lane % kRowLanes;
  const int quads = (lq + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int quad = warp; quad < quads; quad += kWarps) {
    const int t = quad * kRowsPerWarp + lane / kRowLanes;
    const bool row_ok = t < lq;
    const int* row = sim + (static_cast<long long>(q) * lq + (row_ok ? t : 0)) * row_len +
                     static_cast<long long>(d0) * ld;
    for (int d = 0; d < nd; ++d) {
      const int lo = s_lo[d], hi = s_hi[d];
      if (hi <= lo) continue;  // no valid token: the same for every lane
      const int* doc = row + static_cast<long long>(d) * ld;
      const uint8_t* doc_mask = mask + static_cast<long long>(d0 + d) * ld;
      float best = -__int_as_float(0x7f800000);
      for (int v0 = lo + g; v0 < hi; v0 += kRowLanes * kUnroll) {
        int x[kUnroll][V];
        uint32_t bits[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = v0 + u * kRowLanes;
          bits[u] = row_ok && v < hi ? mask_word<V>(doc_mask + v * V) : 0u;
          if (bits[u]) load_sims<V>(doc + v * V, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if ((bits[u] >> (8 * k)) & 0xffu) best = fmaxf(best, bf16_of(x[u][k]));
          }
        }
      }
#pragma unroll
      for (int o = kRowLanes / 2; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
      if (g == 0 && row_ok) s_max[t * kDocs + d] = s_masked[d] ? fmaxf(best, masked_fill) : best;
    }
  }
  __syncthreads();

  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    float* col = s_max + d;  // row t at col[t * kDocs]
    for (int n = lq; n > 1;) {
      const int half = n / 2;
      for (int i = 0; i < half; ++i) col[i * kDocs] = __fadd_rn(col[i * kDocs], col[(i + half) * kDocs]);
      if (n % 2) col[half * kDocs] = col[2 * half * kDocs];
      n = half + n % 2;
    }
    const float score = s_lo[d] < s_hi[d] ? __fmul_rn(__fmul_rn(col[0], qscale[q]), dscale[d0 + d])
                                          : -__int_as_float(0x7f800000);
    out[static_cast<long long>(q) * out_stride + d0 + d] = score;
  }
}

template <int V>
int launch(const int* sim, const uint8_t* mask, const float* qscale, const float* dscale, float* out,
           long long out_stride, int nq, int lq, int c, int ld, cudaStream_t stream) {
  const int tiles = (c + kDocs - 1) / kDocs;
  const size_t smem = static_cast<size_t>(lq) * kDocs * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(maxsim_epilogue_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>(static_cast<long long>(nq) * tiles);
  maxsim_epilogue_kernel<V><<<blocks, kWarps * 32, smem, stream>>>(sim, mask, qscale, dscale, out, out_stride, lq,
                                                                    c, ld, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// sim [nq*lq, c*ld] int32 and mask [c, ld] bool (one byte a token), both
// contiguous; qscale [nq] and dscale [c] f32; out points at row 0, column 0 of
// the chunk's [nq, c] scores, rows out_stride floats apart; all on the current
// device. Returns a cudaError_t: 0 when the launch was accepted.
int maxsim_epilogue_launch(const void* sim, const void* mask, const void* qscale, const void* dscale, void* out,
                           long long out_stride, int nq, int lq, int c, int ld, void* stream) {
  if (nq <= 0 || lq <= 0 || c <= 0 || ld <= 0 || static_cast<long long>(nq) * ((c + kDocs - 1) / kDocs) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = reinterpret_cast<uintptr_t>(sim), m = reinterpret_cast<uintptr_t>(mask);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int*>(sim);
  const auto* mp = static_cast<const uint8_t*>(mask);
  const auto* qs = static_cast<const float*>(qscale);
  const auto* ds = static_cast<const float*>(dscale);
  auto* o = static_cast<float*>(out);
  if (ld % 4 == 0 && s % 16 == 0 && m % 4 == 0) return launch<4>(sp, mp, qs, ds, o, out_stride, nq, lq, c, ld, st);
  if (ld % 2 == 0 && s % 8 == 0 && m % 2 == 0) return launch<2>(sp, mp, qs, ds, o, out_stride, nq, lq, c, ld, st);
  return launch<1>(sp, mp, qs, ds, o, out_stride, nq, lq, c, ld, st);
}

}  // extern "C"
