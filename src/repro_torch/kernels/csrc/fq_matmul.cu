// K2: fully quantized integer matmul with the fused requant/dequant epilogue
// (paper eq. 4).
//
// Replaces repro/kernels/fq_matmul.py::fq_matmul (Pallas _kernel on a
// (M/bm, N/bn, K/bk) grid with an int32 VMEM accumulator and
// apply_epilogue). (M, K) int8 x (K, N) int8 -> int32, then
//   requant: clip(rint(f32(acc) * scale), lo, n_out) -> int8, or
//   dequant: f32(acc) * scale                        -> f32.
//
// Design (igemm_tc.cuh): one 64 x 64 output tile per block, the whole K
// reduction in int32 registers, on the tensor cores: two warpgroups each run
// wgmma.m64n32k32.s32.s8.s8 from a 6-stage ring of shared tiles, with no
// padded copies in device memory and the scale read from a device pointer.
// A takes one of two loaders, picked by the wrapper per launch: 16-byte
// cp.async (zero-filled past M and K) when K % 16 == 0 and A is 16-byte
// aligned (every DarkNet im2col GEMM, K 288 ... 4608), else the byte
// gather below (the KWS path's K = 300 and 135). B, (K, N) row-major as in
// the reference, lands in shared memory as it is and is transposed there
// to the K-major words that 8-bit wgmma takes.
//
// Bound: on the KWS path (M = B * T_out, K = 300 or 135, N = 45) the
// product is a few MFLOP against ~1 MB of codes, a few microseconds or less
// at the card's int8 rate and its bandwidth: launch- and latency-bound. On
// DarkNet at B = 8 the 17 GEMMs are 43.2 G int8 ops over 139 MB of patches,
// weights and outputs, 22 us at the tensor cores' peak against 41 us of
// bytes: bound by bytes at the peaks, in practice by the loop's per-stage
// latency (two barriers and the B transpose per 64-code stage) and by the
// grid of 64 x 64 tiles.
//
// K5: with packed B (factor 2 or 4: (ceil(K / factor), N) uint8 bytes from
// core/quant.py::pack_codes) the tile loop decodes each byte into the
// shared B tile (igemm_tc.cuh, LoadB); the pad rows past K meet A lanes
// that load 0. The weight bytes read fall by the factor.
//
// K4, the ADC noise (replaces fq_matmul.py:52-66 and :98-105): with a
// sigma pointer, the epilogue adds the noise.cuh field at the global index
// m * N + n to f32(acc) and requantizes the float32 value. NOISE is a
// template parameter, so the clean instantiations carry no field code.
#include "igemm_tc.cuh"

namespace {

// A is (M, K) row-major; the thread's rows are ROW_STEP rows apart.
struct MatA {
  const int8_t* a;
  int M, K, r0;  // r0: the thread's first row
  struct Col { int k; bool ok; };
  __device__ __forceinline__ MatA(const int8_t* a_, int M_, int K_, int m0,
                                  int tid)
      : a(a_), M(M_), K(K_), r0(m0 + tid / fq::tc::BK) {}
  __device__ __forceinline__ Col col(int k) const { return {k, k < K}; }
  __device__ __forceinline__ int8_t at(int q, const Col& c) const {
    const int m = r0 + q * fq::tc::ROW_STEP;
    return (c.ok && m < M) ? a[(long long)m * K + c.k] : (int8_t)0;
  }
};

// The vector loader: thread tid's 16 bytes of tile row tc::vec_row(tid),
// zero-filled past M and K (K % 16 == 0, A 16-byte aligned).
struct MatAVec {
  const int8_t* a;
  int M, K, r, m, kc;
  __device__ __forceinline__ MatAVec(const int8_t* a_, int M_, int K_,
                                     int m0, int tid)
      : a(a_), M(M_), K(K_), r(fq::tc::vec_row(tid)), m(m0 + r),
        kc(fq::tc::vec_chunk(tid)) {}
  __device__ __forceinline__ void issue(int8_t* tile, int k0) const {
    const int k = k0 + 16 * kc;
    const bool ok = m < M && k < K;
    fq::tc::cp_async16(tile + fq::tc::tile_off(r, 16 * kc),
                       ok ? a + (long long)m * K + k : a, ok ? 16 : 0);
  }
};

template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int M, int N, int K, int lo, int n_out, bool bvec,
                 fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * fq::tc::BM, n0 = blockIdx.y * fq::tc::BN;
  int acc[16];
  const int rows = (K + FACTOR - 1) / FACTOR;
  if constexpr (AVEC)
    fq::tc::mainloop<FACTOR, true>(smem, MatAVec(a, M, K, m0, tid), w, K,
                                   rows, N, n0, bvec, tid, acc);
  else
    fq::tc::mainloop<FACTOR, false>(smem, MatA(a, M, K, m0, tid), w, K,
                                    rows, N, n0, bvec, tid, acc);
  const fq::tc::FragMap map(tid);
  if constexpr (NOISE) {
    float v[16];
    fq::noisy_tile(v, acc, fq::Noise::load(na), M, N, m0, n0, map);
    fq::store<DEQUANT>(out, v, *scale, lo, n_out, M, N, m0, n0, map);
  } else {
    fq::store<DEQUANT>(out, acc, *scale, lo, n_out, M, N, m0, n0, map);
  }
}

}  // namespace

// factor: codes per byte of w (1 int8, 2 int4, 4 ternary); w holds
// ceil(K / factor) rows. avec: A's vector loader (K % 16 == 0, a 16-byte
// aligned), else the byte gather; bvec: B's 16-byte cp.async (N % 16 ==
// 0, w 16-byte aligned), else masked byte loads. sigma (float32) and seed
// (uint32) are device scalars, or null for the clean epilogue; chunks >= 1
// with noise.
extern "C" int fq_matmul_s8(const void* a, const void* w, const void* scale,
                            void* out, const void* sigma, const void* seed,
                            int M, int N, int K, int factor, int dequant,
                            int lo, int n_out, int chunks, int avec, int bvec,
                            void* stream) {
  cudaError_t err = cudaSuccess;
  if (sigma && chunks < 1) return (int)cudaErrorInvalidValue;
  if ((avec && ((uintptr_t)a % 16 || K % 16)) ||
      (bvec && ((uintptr_t)w % 16 || N % 16)))
    return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    dim3 grid((M + fq::tc::BM - 1) / fq::tc::BM,
              (N + fq::tc::BN - 1) / fq::tc::BN);
    cudaStream_t st = (cudaStream_t)stream;
    const int8_t *as = (const int8_t*)a, *ws = (const int8_t*)w;
    const float* sc = (const float*)scale;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    const cudaError_t bad = fq::with_factor(factor, [&](auto f) {
      constexpr int F = decltype(f)::value;
      fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
        constexpr bool DQ = decltype(dq)::value, NZ = decltype(nz)::value;
        err = avec ? fq::tc::launch(fq_matmul_kernel<DQ, F, NZ, true>, grid,
                                    st, as, ws, sc, out, M, N, K, lo, n_out,
                                    bvec != 0, na)
                   : fq::tc::launch(fq_matmul_kernel<DQ, F, NZ, false>, grid,
                                    st, as, ws, sc, out, M, N, K, lo, n_out,
                                    bvec != 0, na);
      });
    });
    if (bad != cudaSuccess) err = bad;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
