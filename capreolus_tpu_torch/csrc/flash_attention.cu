// K2 on Hopper: masked multi-head attention with an online softmax.
//
// Replaces the TPU kernel capreolus_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_attention_tpu). For each (batch b, head h) and query
// row i of q, k, v [B, H, L, D] and the key mask [B, L]:
//   s[j]   = <q[i] * (1/sqrt(D)), k[j]>          in f32, q scaled first
//          , -1e30 where mask[b, j] == 0
//   out[i] = sum_j exp(s[j] - m) v[j] / max(sum_j exp(s[j] - m), 1e-30)
// with the max m, the sum and the accumulator carried across key tiles as an
// online softmax in f32, and the output cast to the input dtype. A row whose
// keys are all masked gets the mean of V, as in both JAX paths at f32. The
// [L, L] score matrix never reaches device memory.
//
// Inputs: f32 or bf16 (one template; the math is f32 either way), D in
// {32, 64, 128}, any L >= 1 (the ragged last tile is masked here, so the
// Pallas kernel's L % 128 == 0 does not carry over). The mask is read per
// batch element, never broadcast to [B*H, L].
//
// What bounds it on an H100: operations. At the served shape (B = 1600
// passages, H = 12, L = 256, D = 64, f32) the function moves q, k, v and the
// output once, 5.0 GB, in 1.5 ms at 3.35 TB/s, but does 4*L*D FLOP per
// (row, key) pair, 322 GFLOP with every key unmasked, 4.8 ms at the card's
// 67 TFLOP/s f32 rate outside the tensor cores. chip_smoke.py counts the bound
// from each run's mask.
//
// Design, simple and right first: one block of 128 threads per (b*h, tile of
// 128 query rows), one query row per thread. The scaled query rows sit in
// shared memory, transposed so that a warp reads 32 consecutive floats. Keys
// and values come in tiles of 32 through shared memory (K transposed, so that
// one broadcast float4 feeds 4 scores); each thread keeps its 32 scores and
// its D accumulators in registers. True f32 FMA dot products, expf and an
// IEEE division at the end: no TF32, no fast math. Sums run in a fixed order
// and nothing is atomic, so a result is the same from run to run.
//
// Masked tiles: when a batch element has at least one unmasked key, a tile of
// keys that are all masked adds exactly nothing (exp(-1e30 - m) is 0 in f32
// for any finite score m, and a later tile's rescale by exp(-1e30 - m) = 0
// clears what an earlier one added), so such tiles are skipped; the pad
// passages of BERT-MaxP serving are mostly masked keys. A batch element with
// no unmasked key runs every tile, giving the mean of V.
//
// Left for later work: wgmma and TMA, bf16 tensor cores, several query rows
// per thread for more reuse of each shared-memory load, and fusing the head
// split and transpose ([B, L, H, D] -> [B, H, L, D]) into the loads.

#include <climits>
#include <cmath>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kThreads = kBlockQ;
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &t.x, sizeof(lo));
  memcpy(&hi, &t.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  memcpy(&t.x, &lo, sizeof(lo));
  memcpy(&t.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const unsigned char* __restrict__ mask, T* __restrict__ out, int H, int L,
                       float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [D][kBlockQ]: scaled query rows, transposed
  float* kt_s = q_s + D * kBlockQ;  // [D][kBlockK]: the key tile, transposed
  float* v_s = kt_s + D * kBlockK;  // [kBlockK][D]: the value tile
  __shared__ int code_s[kBlockK];   // per key of the tile: 1 attend, 0 masked, -1 past L

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = blockIdx.y * kBlockQ + tid;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const unsigned char* mrow = mask + static_cast<size_t>(bh / H) * L;

  int any = 0;
  for (int j = tid; j < L; j += kThreads) any |= mrow[j];
  const bool skip_masked_tiles = __syncthreads_or(any) != 0;

#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < L) load4(q + base + static_cast<size_t>(row) * D + 4 * d4, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) q_s[(4 * d4 + c) * kBlockQ + tid] = x[c] * scale;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int key0 = 0; key0 < L; key0 += kBlockK) {
    int code = -1;
    if (tid < kBlockK && key0 + tid < L) code = mrow[key0 + tid] != 0;
    // also the barrier after every thread's reads of the previous tile
    const bool tile_has_key = __syncthreads_or(code == 1) != 0;
    if (skip_masked_tiles && !tile_has_key) continue;
    if (tid < kBlockK) code_s[tid] = code;
    for (int idx = tid; idx < kBlockK * (D / 4); idx += kThreads) {
      const int j = idx % kBlockK;  // lanes on consecutive keys: conflict-free transposed stores
      const int d4 = idx / kBlockK;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (key0 + j < L) load4(k + base + static_cast<size_t>(key0 + j) * D + 4 * d4, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) kt_s[(4 * d4 + c) * kBlockK + j] = x[c];
    }
    for (int idx = tid; idx < kBlockK * (D / 4); idx += kThreads) {
      const int j = idx / (D / 4);
      const int d4 = idx % (D / 4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (key0 + j < L) load4(v + base + static_cast<size_t>(key0 + j) * D + 4 * d4, x);
      store4(v_s + j * D + 4 * d4, x);
    }
    __syncthreads();

    float s[kBlockK];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[d * kBlockQ + tid];
      const float4* kr = reinterpret_cast<const float4*>(kt_s + d * kBlockK);
#pragma unroll
      for (int j4 = 0; j4 < kBlockK / 4; ++j4) {
        const float4 kk = kr[j4];
        s[4 * j4 + 0] = fmaf(qd, kk.x, s[4 * j4 + 0]);
        s[4 * j4 + 1] = fmaf(qd, kk.y, s[4 * j4 + 1]);
        s[4 * j4 + 2] = fmaf(qd, kk.z, s[4 * j4 + 2]);
        s[4 * j4 + 3] = fmaf(qd, kk.w, s[4 * j4 + 3]);
      }
    }

    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const int c = code_s[j];
      s[j] = c == 1 ? s[j] : (c == 0 ? kNegInf : -INFINITY);  // past L: no weight at all
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = s[j];
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (row < L) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float x[4] = {acc[4 * d4] / denom, acc[4 * d4 + 1] / denom, acc[4 * d4 + 2] / denom,
                          acc[4 * d4 + 3] / denom};
      store4(out + base + static_cast<size_t>(row) * D + 4 * d4, x);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask, void* out, int B, int H,
           int L, cudaStream_t stream) {
  const int smem = (D * kBlockQ + 2 * D * kBlockK) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (L + kBlockQ - 1) / kBlockQ);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), H, L, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const unsigned char* mask, void* out, int B,
             int H, int L, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, H, L, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, H, L, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, H, L, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, H, L, D] contiguous, f32 (dtype 0) or bf16 (dtype 1), 16-byte
// aligned; mask [B, L] of bytes, nonzero = attend. All on the current device.
// Returns a cudaError_t: 0 when the launch was accepted.
int flash_attention_launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                           int B, int H, int L, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || static_cast<long long>(B) * H > INT_MAX ||
      (L + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, m, out, B, H, L, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, m, out, B, H, L, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
