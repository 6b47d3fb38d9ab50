// The fused requant/dequant "ADC" epilogue, shared by fq_matmul.cu and
// fq_conv.cu so the two kernels stay bit-identical.
//
// Replaces repro/kernels/fq_matmul.py::apply_epilogue:
//   requant: clip(round(f32(acc) * scale), lo, n_out) -> int8
//   dequant: f32(acc) * scale                         -> f32
// The _f twins take the float32 accumulator itself: the noisy one, f32(acc)
// plus the ADC noise of noise.cuh.
// The multiply is one IEEE round-to-nearest product (__fmul_rn, and the
// library builds with --fmad=false); rounding is rintf, half to even like
// jnp.round, never roundf (which rounds halves away from zero).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int8_t fq_requant_f(float accf, float scale,
                                               int lo, int n_out) {
  float y = rintf(__fmul_rn(accf, scale));
  y = fminf(fmaxf(y, (float)lo), (float)n_out);
  return (int8_t)__float2int_rn(y);
}

__device__ __forceinline__ float fq_dequant_f(float accf, float scale) {
  return __fmul_rn(accf, scale);
}

__device__ __forceinline__ int8_t fq_requant(int acc, float scale, int lo,
                                             int n_out) {
  return fq_requant_f(__int2float_rn(acc), scale, lo, n_out);
}

__device__ __forceinline__ float fq_dequant(int acc, float scale) {
  return fq_dequant_f(__int2float_rn(acc), scale);
}

// Each library carries its own copy (loaded RTLD_LOCAL), so the Python side
// can name the error a C entry returned.
extern "C" const char* fq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
