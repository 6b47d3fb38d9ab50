// What the kernels on the tensor-core tile loop (igemm_tc.cuh: K2 in
// fq_matmul.cu, K3 and K3b in fq_conv.cu) share around it: the host
// dispatch over the weight format and the epilogue flags, and the masked
// epilogue of epilogue.cuh with, when the ADC noise is on (K4), the noisy
// tile of noise.cuh. A Map places element e of a thread's Map::N
// accumulators at tile row map.row(e), column map.col(e) (tc::FragMap, or
// a pool kernel's map of its rows).
#pragma once

#include <type_traits>

#include "epilogue.cuh"
#include "noise.cuh"

namespace fq {

// Host side: calls f(std::integral_constant<int, FACTOR>) for a weight
// format's factor (1, 2 or 4); any other factor is cudaErrorInvalidValue.
template <class F>
inline cudaError_t with_factor(int factor, F&& f) {
  switch (factor) {
    case 1: f(std::integral_constant<int, 1>{}); return cudaSuccess;
    case 2: f(std::integral_constant<int, 2>{}); return cudaSuccess;
    case 4: f(std::integral_constant<int, 4>{}); return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// Host side: calls f(std::bool_constant<a>, std::bool_constant<b>).
template <class F>
inline void with_flags(bool a, bool b, F&& f) {
  if (a) {
    if (b) f(std::true_type{}, std::true_type{});
    else f(std::true_type{}, std::false_type{});
  } else {
    if (b) f(std::false_type{}, std::true_type{});
    else f(std::false_type{}, std::false_type{});
  }
}

// One output element through the shared epilogue: f32 or int8 at out[o],
// from the int32 accumulator or (noisy) a float32 one.
template <bool DEQUANT>
__device__ __forceinline__ void put(void* __restrict__ out, long long o,
                                    int acc, float scale, int lo, int n_out) {
  if (DEQUANT)
    static_cast<float*>(out)[o] = fq_dequant(acc, scale);
  else
    static_cast<int8_t*>(out)[o] = fq_requant(acc, scale, lo, n_out);
}

template <bool DEQUANT>
__device__ __forceinline__ void put(void* __restrict__ out, long long o,
                                    float accf, float scale, int lo,
                                    int n_out) {
  if (DEQUANT)
    static_cast<float*>(out)[o] = fq_dequant_f(accf, scale);
  else
    static_cast<int8_t*>(out)[o] = fq_requant_f(accf, scale, lo, n_out);
}

// K4: the thread's Map::N accumulators plus the ADC noise at their global
// (row m, column n) of the M x N output; entries outside it are 0 and are
// never stored.
template <class Map>
__device__ __forceinline__ void noisy_tile(float* v, const int* acc,
                                           const Noise& nz, int M, int N,
                                           int m0, int n0, const Map& map) {
#pragma unroll
  for (int e = 0; e < Map::N; ++e) {
    const int m = m0 + map.row(e), n = n0 + map.col(e);
    v[e] = (m < M && n < N) ? nz.add(acc[e], m, N, n) : 0.0f;
  }
}

// Masked store of the thread's Map::N outputs (int32 or float32
// accumulators) through the shared epilogue.
template <bool DEQUANT, class Map, class T>
__device__ __forceinline__ void store(void* __restrict__ out, const T* acc,
                                      float scale, int lo, int n_out, int M,
                                      int N, int m0, int n0, const Map& map) {
#pragma unroll
  for (int e = 0; e < Map::N; ++e) {
    const int m = m0 + map.row(e), n = n0 + map.col(e);
    if (m < M && n < N)
      put<DEQUANT>(out, (long long)m * N + n, acc[e], scale, lo, n_out);
  }
}

}  // namespace fq
