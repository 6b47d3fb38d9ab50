// K1: learned quantization to int8 codes (paper eq. 1 + 2).
//
// Replaces repro/kernels/quantize.py::quantize_codes (Pallas _kernel, row
// tiles of 256 through VMEM). Elementwise:
//   codes = rint(clip(x * inv_scale, b, 1) * n) -> int8
// in exactly that order, with round half to even.
//
// Bound: bytes. 4 bytes read and 1 written per element, one multiply-clip-
// multiply-round in between, far below the card's operations-per-byte
// line. The design keeps it a single streaming pass: a grid-stride loop of
// coalesced loads, and inv_scale read from a device pointer, so the
// caller never syncs the host for a scalar (no .item()).
#include "epilogue.cuh"

__global__ void quantize_codes_kernel(const float* __restrict__ x,
                                      const float* __restrict__ inv_scale,
                                      int8_t* __restrict__ out, long long n,
                                      float b, float levels) {
  const float inv = *inv_scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float u = __fmul_rn(x[i], inv);
    u = fminf(fmaxf(u, b), 1.0f);
    out[i] = (int8_t)__float2int_rn(__fmul_rn(u, levels));
  }
}

extern "C" int fq_quantize_codes(const void* x, const void* inv_scale,
                                 void* out, long long n, float b, int levels,
                                 void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 8192) blocks = 8192;
    quantize_codes_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)x, (const float*)inv_scale, (int8_t*)out, n, b,
        (float)levels);
  }
  return (int)cudaGetLastError();
}
