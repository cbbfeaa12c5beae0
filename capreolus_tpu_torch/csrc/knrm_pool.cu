// K1 on Hopper: fused KNRM similarity matrix + RBF kernel pooling.
//
// Replaces the TPU kernel capreolus_tpu/ops/simmat.py::_knrm_kernel (launched
// by _knrm_pool_pallas). For each batch element b:
//   sim[q, d]  = <q_emb[b, q], d_emb[b, d]>            (rows pre-normalised;
//                                                       pad and OOV rows zero)
//              + 1 where qtok == dtok < 0               (OOV exact match)
//              , zeroed where qtok == 0 or dtok == 0    (padding)
//   ksum[q, k] = sum_{d < D} exp(-0.5 (sim - mu_k)^2 / sigma_k^2)
//   out[b, k]  = sum_q [sum_d sim[q, d] != 0] * log(ksum[q, k] + 1e-6)
// The [B, K, Q, D] kernel tensor and even the [Q, D] similarity tile never
// reach device memory.
//
// Pad doc positions: they count in ksum at sim = 0, as in the model's own
// path (capreolus_tpu/reranker/common.py::knrm_pool). The Pallas kernel also
// masks their kernel values, so on a document shorter than D it disagrees with
// its XLA fallback; the port keeps the model's semantics, so one checkpoint
// scores the same on the GPU and the CPU. Both agree on unpadded documents.
//
// What bounds it on an H100: memory. At the serving shape (B=100 candidates,
// Q=4, D=800, E=300, K=11) the embeddings span B*(Q+D)*E*4 B = 96.5 MB, but a
// row whose id is <= 0 (pad or OOV) is zero by contract, so its similarity
// follows from the ids alone: the function needs only the rows of ids > 0,
// 4*E bytes per real token. With about a third of the doc positions pad, as in
// chip_smoke.py's serving case, that is about 60 MB against 2*E FLOP of f32
// dot products per (q, d) pair of real tokens (about 2 FLOP per byte, far
// below the card's f32 ridge), so the least time is the read: about 18 us at
// 3.35 TB/s. chip_smoke.py::k1_bound_ms counts it from each run's ids.
//
// Design (one block per batch element, a warp per doc row with a butterfly
// per dot product, left 100 blocks on 132 SMs waiting on one row's loads at a
// time):
// - D is split over `splits` blocks per batch element (ops/simmat.py::
//   knrm_plan; 13 at the serving shape, 1,300 blocks), whose 8 * splits warps
//   take chunks of 8 doc rows in turn, so that many short chains of loads are
//   in flight at once;
// - a pad row (id 0) is never read and never computed: its similarity is 0
//   to every query row, so the warp counts its pad rows and adds that count
//   times the kernel values of sim = 0 once, at the end;
// - the chunk's other rows go in pairs: the warp loads a pair's rows whose id
//   is > 0 together, coalesced as 16-byte loads (E = 300 is 75 float4s; an E
//   off 4 takes scalar loads); an OOV row (id < 0) is zero by contract and is
//   not read either. It forms the 2 rows x 4 query rows dot products against
//   query rows held in shared memory and sums all 8 over the lanes at once
//   (9 shuffles where a butterfly each takes 40);
// - each lane owns up to 8 (q, k) pairs and adds their kernel values row by
//   row in registers;
// - the sums combine in a fixed order: each warp over its rows in ascending
//   d and then its pad rows, the block over its warps in order; each block
//   writes its sums to a workspace and takes a ticket (an integer atomic),
//   and the last block of a batch element adds the blocks' sums in rank
//   order and takes the log over q in order. The tickets lie in the call's
//   own workspace, zeroed on its stream before the launch, so calls on other
//   streams or in a replayed graph never share them. No float atomics: the
//   result is the same from run to run.
//
// Numerics: true f32 FMA dot products, expf/logf (no fast-math intrinsics and
// no TF32): the sigma = 0.001 exact-match kernel turns a 1e-3 error in sim
// into a factor of e^-0.5.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 32;
constexpr int kMaxPairs = 256;  // Q * K
constexpr int kPairsPerLane = kMaxPairs / 32;
constexpr int kMaxE = 512;
constexpr int kMaxSplits = 64;        // blocks per batch element
constexpr int kChunk = 8;             // doc rows per warp task: ids in lanes 0 .. kChunk - 1
constexpr int kGroup = 2;             // doc rows per step of a warp

struct Args {
  const float* q_emb;  // [B, Q, E]
  const float* d_emb;  // [B, D, E]
  const int* qtok;     // [B, Q]
  const int* dtok;     // [B, D]
  const float* mus;    // [K]
  const float* sigmas; // [K]
  float* out;          // [B, K]
  float* work;         // [B, splits, Q * K + Q]: each block's sums
  int* tickets;        // [B], zero at the launch: blocks of a batch element done
  int Q, D, E, K, splits;
};

// A lane's share of an E-float row: NF float4s u = lane + 32 j (VEC), or 16
// floats e = lane + 32 j; zero past E and where `load` is false.
template <bool VEC, int NF>
struct Row {
  static constexpr int kN = VEC ? NF : kMaxE / 32;  // elements per lane
  float x[kN][VEC ? 4 : 1];

  __device__ __forceinline__ void load(const float* row, bool load, int E, int lane) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int u = lane + 32 * j;
      if constexpr (VEC) {
        const float4 v = load && u < E / 4 ? __ldg(reinterpret_cast<const float4*>(row) + u)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        x[j][0] = v.x;
        x[j][1] = v.y;
        x[j][2] = v.z;
        x[j][3] = v.w;
      } else {
        x[j][0] = load && u < E ? __ldg(row + u) : 0.f;
      }
    }
  }
};

// Sums N values over the warp's lanes at once: afterwards lane l holds the
// full sum of value l * N / 32. Each round halves the values a lane holds,
// sending one half to its partner, and the last rounds add one value: for N =
// 8, 4 + 2 + 1 + 1 + 1 shuffles where one butterfly per value takes 40.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int half = N / 2; half >= 1; half /= 2) {
    const int bit = 32 * half / N;
    const bool hi = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = hi ? v[half + i] : v[i];
      const float send = hi ? v[i] : v[half + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
#pragma unroll
  for (int bit = 16 / N; bit >= 1; bit /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], bit);
  return v[0];
}

template <bool VEC, int NF>
__global__ void __launch_bounds__(kThreads, 3) knrm_pool_kernel(const Args a) {
  extern __shared__ __align__(16) float q_s[];  // [ceil(Q / 4) * 4, E], zero rows past Q
  __shared__ float sim_s[kWarps][kGroup][kMaxQ];
  __shared__ float part_s[kWarps][kMaxPairs];
  __shared__ float rows_s[kWarps][kMaxQ];
  __shared__ int ticket_s;
  __shared__ float mu_s[kMaxPairs];
  __shared__ float sg2_s[kMaxPairs];
  __shared__ int qtok_s[kMaxQ];

  const int rank = blockIdx.x % a.splits;
  const int b = blockIdx.x / a.splits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Q = a.Q, D = a.D, E = a.E, K = a.K;
  const int Q4 = (Q + 3) / 4 * 4;
  const float* qb = a.q_emb + static_cast<size_t>(b) * Q * E;
  const float* db = a.d_emb + static_cast<size_t>(b) * D * E;
  const int* dtb = a.dtok + static_cast<size_t>(b) * D;

  for (int i = tid; i < Q4 * E; i += kThreads) q_s[i] = i < Q * E ? qb[i] : 0.f;
  if (tid < Q) qtok_s[tid] = a.qtok[static_cast<size_t>(b) * Q + tid];
  if (tid < K) {
    mu_s[tid] = a.mus[tid];
    sg2_s[tid] = a.sigmas[tid] * a.sigmas[tid];
  }
  __syncthreads();

  const int QK = Q * K;
  float acc[kPairsPerLane];
  int pq[kPairsPerLane], pk[kPairsPerLane];  // this lane's pairs lane + 32 j: query row, kernel
#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) {
    const int pidx = min(lane + 32 * j, QK - 1);
    acc[j] = 0.f;
    pq[j] = pidx / K;
    pk[j] = pidx % K;
  }
  float rowacc = 0.f;  // lane q < Q: sum over this warp's doc rows of sim[q, d]
  int pads = 0;        // this warp's pad rows (id 0): each adds the kernel values of sim = 0

  // The batch element's warps take chunks of kChunk doc rows in turn. A
  // chunk's rows whose id is not 0 go in groups of kGroup: the warp loads the
  // group's rows whose id is > 0 together (coalesced, 16 bytes a lane), forms
  // the rows x 4 query rows dot products and sums them over the lanes at once;
  // then each lane adds its (q, k) pairs' kernel values row by row.
  constexpr int kV = 4 * kGroup;  // dot products of a group and four query rows
  const int chunks = (D + kChunk - 1) / kChunk;
  for (int ch = rank * kWarps + warp; ch < chunks; ch += kWarps * a.splits) {
    const int d0 = ch * kChunk;
    const bool in_chunk = lane < kChunk && d0 + lane < D;
    const int id = in_chunk ? __ldg(dtb + d0 + lane) : 0;
    pads += __popc(__ballot_sync(0xffffffffu, in_chunk && id == 0));
    unsigned todo = __ballot_sync(0xffffffffu, id != 0);
    while (todo) {
      int rr[kGroup], dt[kGroup];  // the group's rows in the chunk (-1: none) and their ids
      Row<VEC, NF> rows[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        rr[k] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        dt[k] = rr[k] < 0 ? 0 : __shfl_sync(0xffffffffu, id, rr[k]);
        rows[k].load(db + static_cast<size_t>(d0 + max(rr[k], 0)) * E, dt[k] > 0, E, lane);
      }
      for (int q4 = 0; q4 < Q; q4 += 4) {
        float v[kV];  // v[4 k + u]: row k, query row q4 + u
#pragma unroll
        for (int i = 0; i < kV; ++i) v[i] = 0.f;
#pragma unroll
        for (int j = 0; j < Row<VEC, NF>::kN; ++j) {
          const int u0 = lane + 32 * j;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* qrow = q_s + (q4 + u) * E;
            float y[VEC ? 4 : 1];
            if constexpr (VEC) {
              const float4 t = u0 < E / 4 ? reinterpret_cast<const float4*>(qrow)[u0] : make_float4(0.f, 0.f, 0.f, 0.f);
              y[0] = t.x;
              y[1] = t.y;
              y[2] = t.z;
              y[3] = t.w;
            } else {
              y[0] = u0 < E ? qrow[u0] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
#pragma unroll
              for (int c = 0; c < (VEC ? 4 : 1); ++c) v[4 * k + u] = fmaf(y[c], rows[k].x[j][c], v[4 * k + u]);
            }
          }
        }
        const float p = reduce_scatter<kV>(v, lane);
        const int idx = lane * kV / 32, k = idx / 4, qi = q4 + idx % 4;  // the sum lane holds
        if (lane % (32 / kV) == 0 && qi < Q) {
#pragma unroll
          for (int kk = 0; kk < kGroup; ++kk) {
            if (kk == k && rr[kk] >= 0) {
              const int qt = qtok_s[qi];
              const bool valid = qt != 0 && dt[kk] != 0;
              const float exact = (qt == dt[kk] && qt < 0) ? 1.f : 0.f;
              sim_s[warp][kk][qi] = valid ? p + exact : 0.f;
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (rr[k] < 0) break;
        if (lane < Q) rowacc += sim_s[warp][k][lane];
#pragma unroll
        for (int j = 0; j < kPairsPerLane; ++j) {
          if (lane + 32 * j < QK) {
            const float adj = sim_s[warp][k][pq[j]] - mu_s[pk[j]];
            acc[j] += expf(-0.5f * adj * adj / sg2_s[pk[j]]);
          }
        }
      }
      __syncwarp();  // sim_s[warp] is rewritten for the next group
    }
  }
  // the pad rows, whose similarity is 0 to every query row
#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) {
    const float adj = 0.f - mu_s[pk[j]];
    acc[j] += static_cast<float>(pads) * expf(-0.5f * adj * adj / sg2_s[pk[j]]);
  }

#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) {
    const int pidx = lane + 32 * j;
    if (pidx < QK) part_s[warp][pidx] = acc[j];
  }
  if (lane < Q) rows_s[warp][lane] = rowacc;
  __syncthreads();

  // the block's sums over its warps, in order, to the workspace; the last
  // block of the batch element to finish adds the blocks' sums in rank order
  float* const mine = a.work + (static_cast<size_t>(b) * a.splits + rank) * (QK + Q);
  for (int pidx = tid; pidx < QK; pidx += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part_s[w][pidx];
    mine[pidx] = s;
  }
  if (tid < Q) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += rows_s[w][tid];
    mine[QK + tid] = s;
  }
  __threadfence();  // the sums are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) ticket_s = atomicAdd(a.tickets + b, 1);
  __syncthreads();
  if (ticket_s != a.splits - 1) return;
  __threadfence();
  const float* all = a.work + static_cast<size_t>(b) * a.splits * (QK + Q);
  float* const tot = &part_s[0][0];
  float* const rtot = &rows_s[0][0];
  for (int i = tid; i < QK + Q; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < a.splits; ++r) s += __ldcg(all + r * (QK + Q) + i);
    if (i < QK) {
      tot[i] = s;
    } else {
      rtot[i - QK] = s;
    }
  }
  __syncthreads();
  if (tid < K) {
    float pooled = 0.f;
    for (int qi = 0; qi < Q; ++qi) {
      if (rtot[qi] != 0.f) pooled += logf(tot[qi * K + tid] + 1e-6f);
    }
    a.out[static_cast<size_t>(b) * K + tid] = pooled;
  }
}

template <bool VEC, int NF>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = (a.Q + 3) / 4 * 4 * a.E * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(knrm_pool_kernel<VEC, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knrm_pool_kernel<VEC, NF><<<B * a.splits, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it calls knrm_pool_launch.
int knrm_pool_max_q() { return kMaxQ; }
int knrm_pool_max_e() { return kMaxE; }
int knrm_pool_max_pairs() { return kMaxPairs; }
int knrm_pool_warps() { return kWarps; }
int knrm_pool_chunk() { return kChunk; }

// Floats of knrm_pool_launch's `work`: the blocks' sums, then B int32 tickets.
long long knrm_pool_work_floats(int B, int Q, int K, int splits) {
  return static_cast<long long>(B) * splits * (Q * K + Q) + B;
}

// q_emb [B, Q, E], d_emb [B, D, E] f32; qtok [B, Q], dtok [B, D] int32;
// mus, sigmas [K] f32; out [B, K] f32. All contiguous on the current device.
// splits: blocks per batch element (ops/simmat.py::knrm_plan), 1..64; work
// the call's scratch of knrm_pool_work_floats(B, Q, K, splits) floats: the
// blocks' sums [B, splits, Q * K + Q] f32, then B int32 tickets, which are
// zeroed on `stream` before the kernel. Returns a cudaError_t: 0 when the
// memset and the launch were accepted.
int knrm_pool_launch(const float* q_emb, const float* d_emb, const int* qtok, const int* dtok,
                     const float* mus, const float* sigmas, float* out, float* work,
                     int B, int Q, int D, int E, int K, int splits, void* stream) {
  if (B <= 0 || Q <= 0 || Q > kMaxQ || D <= 0 || E <= 0 || E > kMaxE || K <= 0 ||
      Q * K > kMaxPairs || splits < 1 || splits > kMaxSplits || static_cast<long long>(B) * splits > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* const tickets = reinterpret_cast<int*>(work + static_cast<size_t>(B) * splits * (Q * K + Q));
  const Args a = {q_emb, d_emb, qtok, dtok, mus, sigmas, out, work, tickets, Q, D, E, K, splits};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(tickets, 0, static_cast<size_t>(B) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(d_emb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q_emb) % 16 == 0;
  if (!vec) return launch<false, 4>(a, B, s);
  switch ((E / 4 + 31) / 32) {  // float4s of a row per lane
    case 1: return launch<true, 1>(a, B, s);
    case 2: return launch<true, 2>(a, B, s);
    case 3: return launch<true, 3>(a, B, s);
    default: return launch<true, 4>(a, B, s);
  }
}

}  // extern "C"
