// K2: fully quantized integer matmul with the fused requant/dequant epilogue
// (paper eq. 4).
//
// Replaces repro/kernels/fq_matmul.py::fq_matmul (Pallas _kernel on a
// (M/bm, N/bn, K/bk) grid with an int32 VMEM accumulator and
// apply_epilogue). (M, K) int8 x (K, N) int8 -> int32, then
//   requant: clip(rint(f32(acc) * scale), lo, n_out) -> int8, or
//   dequant: f32(acc) * scale                        -> f32.
//
// Bound: on the KWS path (M = B * T_out, K = 300 or 135, N = 45) the
// product is a few MFLOP against ~1 MB of codes, so the card's int8 rate
// and its bandwidth both allow a few microseconds or less: the kernel is
// bound by its launch and its latency. The design (igemm.cuh) keeps the
// whole K reduction of one 64 x 64 output tile in registers, one block per
// tile, with __dp4a on shared-memory staged codes and no padded copies in
// device memory; the scale is read from a device pointer. Tensor-core mma
// and TMA are left for the PRs that make it fast.
//
// K5: with packed B (factor 2 or 4: (ceil(K / factor), N) uint8 bytes from
// core/quant.py::pack_codes) the tile loop decodes each byte into the
// shared B tile (igemm.cuh, load_b_tile); the pad rows past K meet A lanes
// that load 0. The weight bytes read fall by the factor.
//
// K4, the ADC noise (replaces fq_matmul.py:52-66 and :98-105): with a
// sigma pointer, the epilogue adds the noise.cuh field at the global index
// m * N + n to f32(acc) and requantizes the float32 value. NOISE is a
// template parameter, so the clean instantiations are the code they were.
#include "igemm.cuh"

namespace {

// A is (M, K) row-major; the thread's rows are ROW_STEP rows apart.
struct MatA {
  const int8_t* a;
  int M, K, r0;  // r0: the thread's first row
  struct Col { int k; bool ok; };
  __device__ __forceinline__ MatA(const int8_t* a_, int M_, int K_, int m0,
                                  int tid)
      : a(a_), M(M_), K(K_), r0(m0 + tid / fq::BK) {}
  __device__ __forceinline__ Col col(int k) const { return {k, k < K}; }
  __device__ __forceinline__ int8_t at(int q, const Col& c) const {
    const int m = r0 + q * fq::ROW_STEP;
    return (c.ok && m < M) ? a[(long long)m * K + c.k] : (int8_t)0;
  }
};

template <bool DEQUANT, int FACTOR, bool NOISE>
__global__ void __launch_bounds__(fq::THREADS)
fq_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int M, int N, int K, int lo, int n_out, fq::NoiseArgs na) {
  __shared__ fq::Tiles s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * fq::BM, n0 = blockIdx.y * fq::BN;
  int acc[4][4] = {};
  const MatA load_a(a, M, K, m0, tid);
  fq::mainloop<FACTOR>(s, load_a, w, K, (K + FACTOR - 1) / FACTOR, N, n0,
                       tid, acc);
  if constexpr (NOISE) {
    float v[4][4];
    fq::noisy_tile(v, acc, fq::Noise::load(na), M, N, m0, n0, tid);
    fq::store<DEQUANT>(out, v, *scale, lo, n_out, M, N, m0, n0, tid);
  } else {
    fq::store<DEQUANT>(out, acc, *scale, lo, n_out, M, N, m0, n0, tid);
  }
}

}  // namespace

// factor: codes per byte of w (1 int8, 2 int4, 4 ternary); w holds
// ceil(K / factor) rows. sigma (float32) and seed (uint32) are device
// scalars, or null for the clean epilogue; chunks >= 1 with noise.
extern "C" int fq_matmul_s8(const void* a, const void* w, const void* scale,
                            void* out, const void* sigma, const void* seed,
                            int M, int N, int K, int factor, int dequant,
                            int lo, int n_out, int chunks, void* stream) {
  cudaError_t err = cudaSuccess;
  if (sigma && chunks < 1) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    dim3 grid((M + fq::BM - 1) / fq::BM, (N + fq::BN - 1) / fq::BN);
    cudaStream_t st = (cudaStream_t)stream;
    const int8_t *as = (const int8_t*)a, *ws = (const int8_t*)w;
    const float* sc = (const float*)scale;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    err = fq::with_factor(factor, [&](auto f) {
      constexpr int F = decltype(f)::value;
      fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
        fq_matmul_kernel<decltype(dq)::value, F, decltype(nz)::value>
            <<<grid, fq::THREADS, 0, st>>>(as, ws, sc, out, M, N, K, lo,
                                           n_out, na);
      });
    });
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
