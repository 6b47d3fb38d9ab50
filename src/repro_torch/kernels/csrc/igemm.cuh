// The dp4a int8 x int8 -> int32 tile loop of K3b (fq_conv.cu's two pool
// kernels), and what it shares with the tensor-core loop of K2 and K3
// (igemm_tc.cuh): the tile shape, the A gathers' thread map, the host
// dispatch, and the masked epilogue of epilogue.cuh with, when the ADC
// noise is on (K4), the noisy tile of noise.cuh.
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
// a loader: a row-major matrix (fq_matmul.cu's MatA) or the convolution
// window gathered in place (fq_conv.cu's ConvA, implicit GEMM); the
// tensor-core loop's byte loader runs the same gathers.
//
// K5, the packed-weight prologue (replaces the unpack in the MAC prologue
// of repro/kernels/fq_matmul.py:86-90 and fq_conv.py:330-333): B may hold
// FACTOR codes per byte (1: int8, 2: int4, 4: ternary), a compile-time
// parameter. Reduction row k lives in byte row k / FACTOR, bit field
// k % FACTOR, little-endian in the byte, two's complement
// (core/quant.py::pack_codes). Each thread loads one byte and writes its
// FACTOR decoded codes into the shared B tile, so the dp4a loop below is
// the int8 one and the FACTOR = 1 instantiation is the int8 loader. The
// weights' device bytes shrink by FACTOR; the MACs do not change.
#pragma once

#include <type_traits>

#include "epilogue.cuh"
#include "noise.cuh"

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

// One field of a packed byte p: ((p >> (i * bits)) & mask ^ sign) - sign.
template <int FACTOR>
__device__ __forceinline__ int8_t unpack_field(int p, int i) {
  constexpr int BITS = 8 / FACTOR;
  constexpr int MASK = (1 << BITS) - 1, SIGN = 1 << (BITS - 1);
  return (int8_t)((((p >> (i * BITS)) & MASK) ^ SIGN) - SIGN);
}

// B is (rows, N) row-major bytes: int8 codes (FACTOR = 1, rows = K) or
// packed ones (rows = ceil(K / FACTOR)). A step covers BK / FACTOR byte
// rows; thread tid loads column tid % BN of byte rows tid / BN + 4 q, so
// neighbouring threads read neighbouring bytes, and writes the byte's
// FACTOR codes to reduction lanes FACTOR * row + i of the shared tile.
template <int FACTOR>
__device__ __forceinline__ void load_b_tile(Tiles& s, const int8_t* __restrict__ w,
                                            int rows, int N, int k0, int n0,
                                            int tid) {
  static_assert(FACTOR == 1 || FACTOR == 2 || FACTOR == 4, "1, 2 or 4");
  int8_t* bs = reinterpret_cast<int8_t*>(s.b);
  const int nl = tid % BN;
  const int n = n0 + nl;
  const int r0 = k0 / FACTOR;
#pragma unroll
  for (int q = 0; q < BN * (BK / FACTOR) / THREADS; ++q) {
    const int rl = tid / BN + q * (THREADS / BN);
    const int r = r0 + rl;
    int8_t v = 0;
    if (r < rows && n < N) v = w[(long long)r * N + n];
    if (FACTOR == 1) {
      bs[nl * (KW * 4) + rl] = v;
    } else {
      const int p = (uint8_t)v;
#pragma unroll
      for (int i = 0; i < FACTOR; ++i)
        bs[nl * (KW * 4) + rl * FACTOR + i] = unpack_field<FACTOR>(p, i);
    }
  }
}

// Thread tid stages A-tile rows tid / BK + q * ROW_STEP (q < ROWS) at
// column tid % BK: neighbouring threads read neighbouring bytes of a row.
constexpr int ROWS = BM * BK / THREADS;
constexpr int ROW_STEP = THREADS / BK;

// LoadA is built per thread and keeps its ROWS rows' state in registers:
//   Col col(int k) const;                per-step prep of reduction index k
//   int8_t at(int q, const Col&) const;  A[m0 + row q][k], 0 outside
// K is the reduction length (A's lanes at or past it load 0); rows is B's
// count of byte rows.
template <int FACTOR, class LoadA>
__device__ __forceinline__ void mainloop(Tiles& s, const LoadA& load_a,
                                         const int8_t* __restrict__ w, int K,
                                         int rows, int N, int n0, int tid,
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
    load_b_tile<FACTOR>(s, w, rows, N, k0, n0, tid);
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

// The dp4a loop's thread map: thread (tx, ty) = (tid % 16, tid / 16) holds
// acc[i][j] at row ty + 16 i, column tx + 16 j; element e = 4 i + j.
struct TileMap {
  static constexpr int N = 16;
  int tx, ty;
  __device__ __forceinline__ explicit TileMap(int tid)
      : tx(tid % 16), ty(tid / 16) {}
  __device__ __forceinline__ int row(int e) const { return ty + 16 * (e / 4); }
  __device__ __forceinline__ int col(int e) const { return tx + 16 * (e % 4); }
};

// K4: the thread's Map::N accumulators plus the ADC noise at their global
// (row m, column n) of the M x N output; entries outside it are 0 and are
// never stored. Map (TileMap, tc::FragMap) places element e of the
// thread's accumulators at tile row map.row(e), column map.col(e).
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
