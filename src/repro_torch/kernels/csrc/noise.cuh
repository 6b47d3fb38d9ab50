// K4, the ADC-noise field of the fused epilogue, shared by fq_matmul.cu and
// fq_conv.cu (through igemm.cuh).
//
// Replaces the noise of repro/kernels/fq_matmul.py (noise_tile, :52-66, and
// its use at :98-105) and repro/kernels/fq_conv.py (:342-355), whose field is
// repro/core/noise.py::hash_u32 / unit_normal_field / mac_noise_field
// (:123-176): a stateless counter hash over the GLOBAL output index
//   idx = row * n_true + col   (uint32, wrapping, as the reference's int32)
// so any tile shape, and the im2col oracle, draws the same value for the
// same output. Per output and chunk salt c < K:
//   base = hash(idx ^ hash(seed + c * GOLDEN))
//   u    = sum over k < 12, in order, of f32(hash(base + (k + 1) * GOLDEN) >> 8)
//   z_c  = u * 2^-24 - 6                  (Irwin-Hall(12): ~N(0, 1))
// and the noise is (sigma / K) * (z_0 + ... + z_{K-1}), summed in order.
// The uint32 multiplies wrap. Every float step is one IEEE round-to-nearest
// operation (__int2float_rn, __fadd_rn, __fmul_rn, __fdiv_rn; the library
// also builds with --fmad=false), so the field is bit-exact with the
// reference's unfused float32 arithmetic and with the plain version
// (repro_torch/core/noise.py).
//
// Bound: per output element and chunk, 13 hashes that depend on the index
// (the seed's hash does not): 103 ALU instructions (shifts, xors, adds),
// 26 wrapping multiplies (IMAD), 12 int-to-float conversions and 15 float
// adds and multiplies, all in registers after the MAC loop. The ALU pipe
// (64 lanes per SM) bounds it; on DarkNet's widest layers that takes
// longer than the int8 MACs (PERF.md, chip_smoke.py's FIELD_PER_CHUNK).
// Sigma and the seed are device scalars read by each thread, like the
// epilogue's scale: nothing goes to the host.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fq {

constexpr uint32_t GOLDEN = 0x9E3779B9u;  // 2^32 / phi
constexpr int IH_DRAWS = 12;

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// unit_normal_field(idx, seed, salt): ~N(0, 1), support [-6, 6].
__device__ __forceinline__ float unit_normal(uint32_t idx, uint32_t seed,
                                             uint32_t salt) {
  const uint32_t base = hash_u32(idx ^ hash_u32(seed + salt * GOLDEN));
  float u = 0.0f;
#pragma unroll
  for (int k = 0; k < IH_DRAWS; ++k) {
    const uint32_t h = hash_u32(base + (uint32_t)(k + 1) * GOLDEN);
    u = __fadd_rn(u, __int2float_rn((int)(h >> 8)));
  }
  return __fadd_rn(__fmul_rn(u, 5.9604644775390625e-8f /* 2^-24 */), -6.0f);
}

// What the wrappers pass: device pointers to sigma (float32, accumulator
// units) and the seed (uint32), and the number of chunks K >= 1. A null
// sigma means no noise; the clean kernels never read these.
struct NoiseArgs {
  const float* sigma;
  const uint32_t* seed;
  int chunks;
};

// The field as one thread evaluates it, after reading the device scalars.
struct Noise {
  float coef;     // sigma / K, one correctly rounded division
  uint32_t seed;
  int chunks;

  __device__ __forceinline__ static Noise load(const NoiseArgs& a) {
    return {__fdiv_rn(*a.sigma, __int2float_rn(a.chunks)), *a.seed, a.chunks};
  }

  // mac_noise_field at global index idx
  __device__ __forceinline__ float at(uint32_t idx) const {
    float total = unit_normal(idx, seed, 0u);
    for (int c = 1; c < chunks; ++c)
      total = __fadd_rn(total, unit_normal(idx, seed, (uint32_t)c));
    return __fmul_rn(coef, total);
  }

  // f32(acc) + the field at output (row, col) of an n_true-column output
  __device__ __forceinline__ float add(int acc, int row, int n_true,
                                       int col) const {
    const uint32_t idx = (uint32_t)row * (uint32_t)n_true + (uint32_t)col;
    return __fadd_rn(__int2float_rn(acc), at(idx));
  }
};

}  // namespace fq
