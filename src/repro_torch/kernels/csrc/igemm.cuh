// Shared int8 x int8 -> int32 tile loop of K2 (fq_matmul.cu) and K3
// (fq_conv.cu), with the fused epilogue of epilogue.cuh.
//
// One block computes a BM x BN output tile with 256 threads; thread
// (tx, ty) = (tid % 16, tid / 16) owns the 4 x 4 outputs at rows
// ty + 16 i and columns tx + 16 j. The reduction runs in BK = 64 steps:
// the A tile (BM x BK) and the B tile, transposed to (BN x BK), are staged
// in shared memory as 32-bit words of 4 int8 codes, and every thread sums
// its 16 outputs with __dp4a (4 int8 products into an int32 per op).
//
// Edges are masked, never padded in device memory: A rows past M, B
// columns past N and reduction indices past K load as 0 in shared memory,
// which makes any K (300 and 135 on the KWS path) legal. The A operand is
// a loader, so K2 reads a row-major matrix and K3 gathers the convolution
// window in place (implicit GEMM) through the same loop.
#pragma once

#include "epilogue.cuh"

namespace fq {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;                 // int8 elements per reduction step
constexpr int THREADS = 256;
constexpr int KW = BK / 4 + 1;         // row stride in words; odd -> no bank
                                       // conflicts on the column reads

struct Tiles {
  int a[BM][KW];
  int b[BN][KW];
};

// B is (K, N) row-major int8. Thread tid loads column tid % BN of rows
// tid / BN + 4 q: neighbouring threads read neighbouring bytes.
__device__ __forceinline__ void load_b_tile(Tiles& s, const int8_t* __restrict__ w,
                                            int K, int N, int k0, int n0,
                                            int tid) {
  int8_t* bs = reinterpret_cast<int8_t*>(s.b);
  const int nl = tid % BN;
  const int n = n0 + nl;
#pragma unroll
  for (int q = 0; q < BN * BK / THREADS; ++q) {
    const int kl = tid / BN + q * (THREADS / BN);
    const int k = k0 + kl;
    int8_t v = 0;
    if (k < K && n < N) v = w[(long long)k * N + n];
    bs[nl * (KW * 4) + kl] = v;
  }
}

// Thread tid stages A-tile rows tid / BK + q * ROW_STEP (q < ROWS) at
// column tid % BK: neighbouring threads read neighbouring bytes of a row.
constexpr int ROWS = BM * BK / THREADS;
constexpr int ROW_STEP = THREADS / BK;

// LoadA is built per thread and keeps its ROWS rows' state in registers:
//   Col col(int k) const;                per-step prep of reduction index k
//   int8_t at(int q, const Col&) const;  A[m0 + row q][k], 0 outside
template <class LoadA>
__device__ __forceinline__ void mainloop(Tiles& s, const LoadA& load_a,
                                         const int8_t* __restrict__ w, int K,
                                         int N, int n0, int tid,
                                         int acc[4][4]) {
  int8_t* as = reinterpret_cast<int8_t*>(s.a);
  const int tx = tid % 16, ty = tid / 16;
  const int kl = tid % BK;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const auto col = load_a.col(k0 + kl);
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int r = tid / BK + q * ROW_STEP;
      as[r * (KW * 4) + kl] = load_a.at(q, col);
    }
    load_b_tile(s, w, K, N, k0, n0, tid);
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.a[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.b[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// One output element through the shared epilogue: f32 or int8 at out[o].
template <bool DEQUANT>
__device__ __forceinline__ void put(void* __restrict__ out, long long o,
                                    int acc, float scale, int lo, int n_out) {
  if (DEQUANT)
    static_cast<float*>(out)[o] = fq_dequant(acc, scale);
  else
    static_cast<int8_t*>(out)[o] = fq_requant(acc, scale, lo, n_out);
}

// Masked store of the thread's 4 x 4 outputs through the shared epilogue.
template <bool DEQUANT>
__device__ __forceinline__ void store(void* __restrict__ out,
                                      const int acc[4][4], float scale,
                                      int lo, int n_out, int M, int N, int m0,
                                      int n0, int tid) {
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      put<DEQUANT>(out, (long long)m * N + n, acc[i][j], scale, lo, n_out);
    }
  }
}

}  // namespace fq
