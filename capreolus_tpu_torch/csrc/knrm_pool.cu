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
// row whose id is <= 0 (pad or OOV) is zero, so its similarity follows from
// the ids alone: the function needs only the rows of ids > 0, 4*E bytes per
// real token. With about a third of the doc positions pad, as in chip_smoke.py's
// serving case, that is about 60 MB against 2*E FLOP of f32 dot products per
// (q, d) pair of real tokens (about 2 FLOP per byte, far below the card's f32
// ridge), so the least time is the read: about 18 us at 3.35 TB/s.
// chip_smoke.py::k1_bound_ms counts it from each run's ids.
//
// Design: one block per batch element, 16 warps. The Q query rows sit in
// shared memory. Each warp walks doc rows d = warp, warp+16, ...; its lanes
// load the row as E/32 coalesced floats held in registers, so every doc row
// is read from device memory once for all Q dot products, and all of a row's
// loads are in flight together. A butterfly shuffle finishes each dot product;
// each lane then owns up to 8 (q, k) pairs and adds their kernel values into
// registers. At the end the 16 per-warp partial sums are reduced in a fixed
// order: no atomics, so the result is the same from run to run.
//
// Numerics: true f32 FMA dot products, expf/logf (no fast-math intrinsics and
// no TF32): the sigma = 0.001 exact-match kernel turns a 1e-3 error in sim
// into a factor of e^-0.5.
//
// Left for later work: skipping the loads of rows whose id is <= 0 (this
// kernel reads every row, pad tails included), fusing the embedding gather +
// normalisation into the kernel (the wrapper materialises q_emb/d_emb, which
// costs more bytes than this kernel reads), 16-byte vector loads, and more
// than one block per batch element so that B=100 fills all 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 32;
constexpr int kMaxPairs = 256;                  // Q * K
constexpr int kPairsPerLane = kMaxPairs / 32;
constexpr int kMaxE = 512;
constexpr int kEPerLane = kMaxE / 32;

__global__ void __launch_bounds__(kThreads)
knrm_pool_kernel(const float* __restrict__ q_emb, const float* __restrict__ d_emb,
                 const int* __restrict__ qtok, const int* __restrict__ dtok,
                 const float* __restrict__ mus, const float* __restrict__ sigmas,
                 float* __restrict__ out, int Q, int D, int E, int K) {
  extern __shared__ float q_s[];  // [Q, E]
  __shared__ float sim_s[kWarps][kMaxQ];
  __shared__ float part_s[kWarps][kMaxPairs];
  __shared__ float rows_s[kWarps][kMaxQ];
  __shared__ float ksum_s[kMaxPairs];
  __shared__ float rowsum_s[kMaxQ];
  __shared__ float mu_s[kMaxPairs];
  __shared__ float sg2_s[kMaxPairs];
  __shared__ int qtok_s[kMaxQ];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* qb = q_emb + static_cast<size_t>(b) * Q * E;
  const float* db = d_emb + static_cast<size_t>(b) * D * E;
  const int* dtb = dtok + static_cast<size_t>(b) * D;

  for (int i = tid; i < Q * E; i += kThreads) q_s[i] = qb[i];
  if (tid < Q) qtok_s[tid] = qtok[static_cast<size_t>(b) * Q + tid];
  if (tid < K) {
    mu_s[tid] = mus[tid];
    sg2_s[tid] = sigmas[tid] * sigmas[tid];
  }
  __syncthreads();

  const int QK = Q * K;
  float acc[kPairsPerLane];
#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) acc[j] = 0.f;
  float rowacc = 0.f;  // lane q < Q: sum over this warp's doc rows of sim[q, d]

  for (int d = warp; d < D; d += kWarps) {
    const int dt = __ldg(dtb + d);
    const float* drow = db + static_cast<size_t>(d) * E;
    float dv[kEPerLane];
#pragma unroll
    for (int j = 0; j < kEPerLane; ++j) {
      const int e = lane + 32 * j;
      dv[j] = e < E ? __ldg(drow + e) : 0.f;
    }
    for (int qi = 0; qi < Q; ++qi) {
      const float* qrow = q_s + qi * E;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kEPerLane; ++j) {
        const int e = lane + 32 * j;
        if (e < E) p = fmaf(qrow[e], dv[j], p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) {
        const int qt = qtok_s[qi];
        const bool valid = qt != 0 && dt != 0;
        const float exact = (qt == dt && qt < 0) ? 1.f : 0.f;
        sim_s[warp][qi] = valid ? p + exact : 0.f;
      }
    }
    __syncwarp();
    if (lane < Q) rowacc += sim_s[warp][lane];
#pragma unroll
    for (int j = 0; j < kPairsPerLane; ++j) {
      const int pidx = lane + 32 * j;
      if (pidx < QK) {
        const int qi = pidx / K;
        const int k = pidx - qi * K;
        const float adj = sim_s[warp][qi] - mu_s[k];
        acc[j] += expf(-0.5f * adj * adj / sg2_s[k]);
      }
    }
    __syncwarp();  // sim_s[warp] is rewritten for the next doc row
  }

#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) {
    const int pidx = lane + 32 * j;
    if (pidx < QK) part_s[warp][pidx] = acc[j];
  }
  if (lane < Q) rows_s[warp][lane] = rowacc;
  __syncthreads();

  for (int pidx = tid; pidx < QK; pidx += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part_s[w][pidx];
    ksum_s[pidx] = s;
  }
  if (tid < Q) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += rows_s[w][tid];
    rowsum_s[tid] = s;
  }
  __syncthreads();

  if (tid < K) {
    float pooled = 0.f;
    for (int qi = 0; qi < Q; ++qi) {
      if (rowsum_s[qi] != 0.f) pooled += logf(ksum_s[qi * K + tid] + 1e-6f);
    }
    out[static_cast<size_t>(b) * K + tid] = pooled;
  }
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it calls knrm_pool_launch.
int knrm_pool_max_q() { return kMaxQ; }
int knrm_pool_max_e() { return kMaxE; }
int knrm_pool_max_pairs() { return kMaxPairs; }

// q_emb [B, Q, E], d_emb [B, D, E] f32; qtok [B, Q], dtok [B, D] int32;
// mus, sigmas [K] f32; out [B, K] f32. All contiguous on the current device.
// Returns a cudaError_t: 0 when the launch was accepted.
int knrm_pool_launch(const float* q_emb, const float* d_emb, const int* qtok, const int* dtok,
                     const float* mus, const float* sigmas, float* out,
                     int B, int Q, int D, int E, int K, void* stream) {
  if (B <= 0 || Q <= 0 || Q > kMaxQ || D <= 0 || E <= 0 || E > kMaxE || K <= 0 ||
      Q * K > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Q * E * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(knrm_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knrm_pool_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q_emb, d_emb, qtok, dtok, mus, sigmas, out, Q, D, E, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
