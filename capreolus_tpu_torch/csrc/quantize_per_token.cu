// Q1 on Hopper: dynamic per-token int8 quantization of a [M, K] f32 matrix.
//
// No TPU kernel: the JAX package leaves _quantize_per_token
// (capreolus_tpu/reranker/bert/encoder.py) to XLA, which fuses it into the
// int8 dot that follows. Here it is the part of the int8 BERT layer that X1's
// epilogue cannot hold: a token's scale needs the amax over all of its K
// columns, and an X1 column tile sees at most 256. For each row m
//   xs[m] = max(amax_k |x[m, k]|, 1e-6) / 127       (true division)
//   q[m, k] = clamp(rint(x[m, k] / xs[m]), -127, 127)
// the rule of ops/quantization.py::quantize_per_token_plain, rounded the same
// way (division, not multiplication by a reciprocal; half to even).
//
// What bounds it on an H100: bytes, 5 per element (a f32 read, an int8 write)
// and 4 per row; at the served [409,600 x 768] that is 1.57 GB, 0.47 ms at
// 3.35 TB/s. Design: one warp per row, 8 rows per block of 256 threads. Where
// K <= 1024 and rows are 16-byte aligned (K % 4 == 0), each lane reads its
// float4s once into registers, the warp reduces the amax with shuffles, and
// the lane writes its codes as 4-byte words from the same registers: one read
// of x, one write of q. Any other K reads the row twice (the second from L1 or
// L2) with scalar accesses.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kVecPerLane = 8;  // float4s a lane holds: K <= 32 * 4 * 8 = 1024 on the register path

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t code(float x, float s) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f)));
}

__device__ __forceinline__ float scale_of(float amax) { return __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f); }

__global__ void __launch_bounds__(kWarps * 32)
    quantize_per_token_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales, int M,
                              int K, int in_registers) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= M) return;
  const float* xr = x + row * K;
  int8_t* qr = q + row * K;
  if (in_registers) {
    float4 v[kVecPerLane];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecPerLane; ++i) {
      const int k = (i * 32 + lane) * 4;
      v[i] = k < K ? *reinterpret_cast<const float4*>(xr + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)), fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
    const float s = scale_of(warp_max(amax));
    if (lane == 0) scales[row] = s;
#pragma unroll
    for (int i = 0; i < kVecPerLane; ++i) {
      const int k = (i * 32 + lane) * 4;
      if (k < K) {
        *reinterpret_cast<char4*>(qr + k) = make_char4(code(v[i].x, s), code(v[i].y, s), code(v[i].z, s),
                                                       code(v[i].w, s));
      }
    }
  } else {
    float amax = 0.0f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(xr[k]));
    const float s = scale_of(warp_max(amax));
    if (lane == 0) scales[row] = s;
    for (int k = lane; k < K; k += 32) qr[k] = code(xr[k], s);
  }
}

}  // namespace

extern "C" {

// x [M, K] f32, q [M, K] int8 and scales [M] f32, contiguous on the current
// device. Returns a cudaError_t: 0 when the launch was accepted.
int quantize_per_token_launch(const void* x, void* q, void* scales, int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int in_registers = K % 4 == 0 && K <= 32 * 4 * kVecPerLane && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const unsigned int blocks = static_cast<unsigned int>((static_cast<long long>(M) + kWarps - 1) / kWarps);
  quantize_per_token_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), M, K, in_registers);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
