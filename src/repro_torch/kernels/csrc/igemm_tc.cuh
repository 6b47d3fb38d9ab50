// The int8 tensor-core tile loop of K2 (fq_matmul.cu), K3 and K3b
// (fq_conv.cu): Hopper's warpgroup MMA (wgmma) on int8 codes, int32
// accumulators. It is the port's one GEMM loop.
//
// One block computes a BM x BN = 64 x 64 output tile with 256 threads, two
// warpgroups; warpgroup g runs wgmma.m64n32k32.s32.s8.s8 on the 64 rows x
// columns 32 g .. 32 g + 31, both operands read from shared memory. The
// reduction runs in stages of BK = 64 codes (two k32 MMAs). Global loads
// go into a ring of RING = 6 stage buffers, PREFETCH = 4 stages ahead of
// the MMAs (schedule at mainloop):
//   * A, vector loader: 16-byte cp.async per thread per stage, the
//     zero-fill form (src-size 0) for rows past M, k past K and the conv
//     halo. K2 takes it when K % 16 == 0 and A is 16-byte aligned, K3 and
//     K3b when Cin % 16 == 0 (a 16-byte chunk of a reduction row is then
//     one tap's channels of one pixel). The wrapper picks it per launch,
//     by shape.
//   * A, byte loader: per-thread gathers (MatA::at, ConvA::at, ROWS = 16
//     bytes a thread, one reduction column) stored straight into the
//     ring. Any K and Cin (the KWS path's 300, 135, cin 100 and 45).
//   * B keeps the JAX layout, (rows, N) row-major bytes, packed along K
//     (K5, the packed-weight prologue, replacing the unpack of
//     repro/kernels/fq_matmul.py:86-90 and fq_conv.py:330-333; FACTOR
//     codes per byte: 1 int8, 2 int4, 4 ternary, core/quant.py::pack_codes),
//     and lands in the ring as it is: 16-byte cp.async chunks (zero-filled
//     past the rows) when N % 16 == 0 and B is 16-byte aligned, else
//     masked byte loads. 8-bit wgmma takes B K-major only, so the step of
//     a stage's MMAs first transposes its B tile in shared memory: each
//     thread reads 4 / FACTOR byte rows x 4 columns, unpacks K5's fields
//     (__vsub4 sign extension of every field of a word at once) and writes
//     4 K-major words (4 consecutive k codes of one n, __byte_perm
//     transposes) into a second, 3-stage ring. Staging B through registers
//     across stages instead left its loads' latency exposed on every stage.
// Operand tiles are 64 rows x 64 bytes of 8 x 16-byte core matrices, no
// swizzle: core matrix (row / 8, k / 16) at ((k / 16) * 8 + row / 8) * 128
// bytes. The transposed B stores of a warp cover one core matrix's 32
// words (each thread rotates its 4 words by (lane / 8) % 4), so they are
// free of bank conflicts; so are the cp.async writes of A (8 lanes per core
// matrix). Raw B rows keep their 16-byte chunks XOR-swizzled by row, so the
// transpose's reads conflict at most 2-way.
//
// s8 x s8 -> s32 in the tensor cores is exact, so every accumulator is the
// exact int32 sum (the largest, 4608 x 128 x 128 ~ 7.5e7, is far below
// 2^31), and the epilogue (igemm.cuh, epilogue.cuh, noise.cuh) runs at
// each accumulator's global (row, col) through FragMap. Which output pixel
// a tile row is belongs to the A loader's row map (fq_conv.cu: one conv
// output pixel, or one position of a pool window), so K3b's pool runs on
// the same accumulators.
//
// Bound: on DarkNet at B = 8 the 17 GEMMs are 43.2 G int8 ops, 22 us at the
// tensor cores' 1,979 T op/s; one 64 x 64 tile per block keeps the grid of
// 64-row tiles. What this design leaves: no TMA, no warp specialisation
// (every thread loads, transposes and waits at two barriers per stage),
// the B transpose in shared memory, a 64-wide tile (m64n32 per warpgroup
// reads A twice from shared memory), and a serial K loop per tile: the
// deep layers at B = 1 and 8 run one block on most SMs, so each stage's
// latency is the kernel's time. K3 cuts that loop where the tile policy
// (kernels/fq_conv.py::pick_blocks) picks a cin block bc < Cin: split-K,
// each block running the range [k_begin, k_end) of one split
// (fq_conv.cu, fq_conv_splitk_kernel).
#pragma once

#include <cstdint>

#include "igemm.cuh"

namespace fq {
namespace tc {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 256;
constexpr int TILE = BM * BK;  // bytes of one operand's tile in a stage
constexpr int RING = 6, PREFETCH = RING - 2, BT_RING = 3;
// The byte loaders' thread map: thread tid gathers tile rows tid / BK +
// q * ROW_STEP (q < ROWS) at column tid % BK, so neighbouring threads read
// neighbouring bytes of a row.
constexpr int ROWS = BM * BK / THREADS;
constexpr int ROW_STEP = THREADS / BK;

// Dynamic shared memory: the A ring, the raw B ring, the transposed B ring.
constexpr int A_OFF = 0, BRAW_OFF = RING * TILE, BT_OFF = 2 * RING * TILE;
constexpr int SMEM_BYTES = (2 * RING + BT_RING) * TILE;  // 61,440

// Byte offset of (row, k) in a 64 x 64 K-major tile of core matrices.
__device__ __forceinline__ int tile_off(int row, int k) {
  return (((k >> 4) * 8 + (row >> 3)) << 7) + ((row & 7) << 4) + (k & 15);
}

// Byte offset of (byte row r, column n) in a raw B stage: 64-byte rows,
// 16-byte chunk n / 16 stored at chunk (n / 16) ^ ((r / 4) % 4).
__device__ __forceinline__ int raw_off(int r, int n) {
  return (r << 6) + ((((n >> 4) ^ (r >> 2)) & 3) << 4) + (n & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy shared stores (st.shared, cp.async) made visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle: start address, LBO (the next core
// matrix along K) and SBO (the next 8 rows), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t LBO = 8 * 128, SBO = 128;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) |
         ((SBO >> 4) << 32);
}

__device__ __forceinline__ void fence_operands(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major) x B (32 x 32, K-major): one warpgroup.
__device__ __forceinline__ void mma_64x32x32(int (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// The accumulators of thread tid: warpgroup g, warp w, lane l hold rows
// 16 w + l / 4 (+ 8) and columns 32 g + 8 i + 2 (l % 4) (+ 1); element e is
// row + 8 ((e / 2) % 2), column + 8 (e / 4) + e % 2.
struct FragMap {
  static constexpr int N = 16;
  int r, c;
  __device__ __forceinline__ explicit FragMap(int tid)
      : r(16 * ((tid % 128) / 32) + (tid % 32) / 4),
        c(32 * (tid / 128) + 2 * (tid % 4)) {}
  __device__ __forceinline__ int row(int e) const {
    return r + 8 * ((e / 2) % 2);
  }
  __device__ __forceinline__ int col(int e) const {
    return c + 8 * (e / 4) + e % 2;
  }
};

// Every field of a word's 4 bytes sign-extended from BITS bits.
template <int BITS>
__device__ __forceinline__ uint32_t sext_fields(uint32_t x) {
  constexpr uint32_t SIGN = 0x01010101u << (BITS - 1);
  return __vsub4(x ^ SIGN, SIGN);
}

// B, (rows, N) bytes, FACTOR codes per byte. A stage is BK / FACTOR byte
// rows x BN columns.
template <int FACTOR>
struct LoadB {
  static_assert(FACTOR == 1 || FACTOR == 2 || FACTOR == 4, "1, 2 or 4");
  static constexpr int RAW = 4 / FACTOR;             // byte rows per word
  static constexpr int CHUNKS = TILE / FACTOR / 16;  // 16 B chunks a stage
  const int8_t* w;
  int rows, N, n0;
  bool vec;
  // fill: chunk tid (tid < CHUNKS) is byte row fr = tid / 4, columns
  // fc = 16 (tid % 4) .. + 15. transpose: columns nl .. nl + 3 and codes
  // 4 k4 .. 4 k4 + 3, where warp wp takes columns 32 (wp % 2) .. + 31 and
  // k words 4 (wp / 2) .. + 3, lane l columns 32 (wp % 2) + 4 (l / 4) and
  // k word 4 (wp / 2) + l % 4; rot spreads the word stores over the banks.
  int fr, fc, nl, k4, rot;

  __device__ __forceinline__ LoadB(const int8_t* w_, int rows_, int N_,
                                   int n0_, int tid, bool vec_)
      : w(w_), rows(rows_), N(N_), n0(n0_), vec(vec_) {
    fr = tid / 4;
    fc = 16 * (tid % 4);
    const int wp = tid / 32, l = tid % 32;
    nl = 32 * (wp % 2) + 4 * (l / 4);
    k4 = 4 * (wp / 2) + l % 4;
    rot = (l / 8) % 4;
  }

  // The thread's raw chunk of the stage at code k0 into a raw B stage:
  // cp.async when N % 16 == 0 (then n < N means the whole chunk is inside
  // the row), else masked byte loads; 0 past the rows and columns.
  __device__ __forceinline__ void fill(int8_t* raw, int k0, int tid) const {
    if (tid >= CHUNKS) return;
    const int r = k0 / FACTOR + fr, n = n0 + fc;
    const int8_t* p = w + (long long)r * N + n;
    int8_t* dst = raw + raw_off(fr, fc);
    if (vec) {
      const bool ok = r < rows && n < N;
      cp_async16(dst, ok ? p : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N)
            v[j / 4] |= (uint32_t)(uint8_t)__ldg(p + j) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }

  // A raw B stage as K-major words (columns nl .. nl + 3) into a B tile.
  __device__ __forceinline__ void transpose(const int8_t* raw,
                                            int8_t* tile) const {
    uint32_t x[RAW];
#pragma unroll
    for (int t = 0; t < RAW; ++t)
      x[t] = *reinterpret_cast<const uint32_t*>(
          raw + raw_off(4 * k4 / FACTOR + t, nl));
    // c[i]: byte j is the code of k = 4 k4 + i at column nl + j
    uint32_t c[4];
    if constexpr (FACTOR == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = x[i];
    } else if constexpr (FACTOR == 2) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        c[2 * t] = sext_fields<4>(x[t] & 0x0F0F0F0Fu);
        c[2 * t + 1] = sext_fields<4>((x[t] >> 4) & 0x0F0F0F0Fu);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[i] = sext_fields<2>((x[0] >> (2 * i)) & 0x03030303u);
    }
    // 4 x 4 byte transpose: v[j] holds the 4 codes of column nl + j
    const uint32_t t0 = __byte_perm(c[0], c[1], 0x5140);
    const uint32_t t1 = __byte_perm(c[2], c[3], 0x5140);
    const uint32_t t2 = __byte_perm(c[0], c[1], 0x7362);
    const uint32_t t3 = __byte_perm(c[2], c[3], 0x7362);
    uint32_t v[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                     __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
    // rotate by rot, so that store s of the warp's lanes covers all 32
    // words of one core-matrix position: v[s] is column (s + rot) % 4
    if (rot & 1) {
      const uint32_t y = v[0];
      v[0] = v[1]; v[1] = v[2]; v[2] = v[3]; v[3] = y;
    }
    if (rot & 2) {
      uint32_t y = v[0]; v[0] = v[2]; v[2] = y;
      y = v[1]; v[1] = v[3]; v[3] = y;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint32_t*>(tile + tile_off(nl + ((s + rot) & 3),
                                                   4 * k4)) = v[s];
  }
};

// The byte loader around a gathering A loader (MatA, ConvA), which keeps
// its ROWS rows' state in registers and provides
//   Col col(int k) const;                per-stage prep of reduction index k
//   int8_t at(int q, const Col&) const;  the code at tile row
//                                        tid / BK + q * ROW_STEP, 0 outside
// Thread tid stores its ROWS bytes into the stage's A tile.
template <class Gather>
__device__ __forceinline__ void gather_a(const Gather& g, int8_t* tile,
                                         int k0, int tid) {
  const int kl = tid % BK;
  const auto col = g.col(k0 + kl);
  int8_t v[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) v[q] = g.at(q, col);
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    tile[tile_off(tid / BK + q * ROW_STEP, kl)] = v[q];
}

// The vector loaders' thread map: thread tid fills the 16 bytes of tile
// row vec_row(tid) at k = 16 vec_chunk(tid), so the 8 lanes of a quarter
// warp write one 128-byte core matrix.
__device__ __forceinline__ int vec_row(int tid) {
  return 8 * (tid / 32) + tid % 8;
}
__device__ __forceinline__ int vec_chunk(int tid) { return (tid % 32) / 8; }

// The tile loop: d (FragMap) += A (rows m0 .., codes k_begin .. k_end) x
// B (the same codes, columns n0 ..). A vector loader (AVEC) provides  void
// issue(int8_t* tile, int k0),  which cp.asyncs the thread's 16 bytes of
// the stage at code k0 (called once per stage, in order); a byte Gather
// (!AVEC) goes through gather_a. The stages start at k_begin (0, or a split
// of K3's split-K: a multiple of 16 with the vector loader, of FACTOR with
// packed B) and A's lanes at or past k_end load 0, so the B rows they meet
// add nothing; rows is B's count of byte rows; bvec picks B's cp.async.
// smem is SMEM_BYTES of dynamic shared memory. It ends with this
// warpgroup's MMAs complete, not the other's: a caller that runs it again
// on the same smem puts a barrier between the calls.
//
// Step kt, for stage kt (slot kt % RING of the A and raw B rings, slot
// kt % BT_RING of the transposed one):
//   1. wait for this thread's cp.asyncs of stage kt; barrier: every
//      thread's loads of stage kt are in shared memory;
//   2. transpose B of stage kt; its slot was last read by the MMAs of step
//      kt - 3, complete since step kt - 2; fence the generic-proxy writes
//      for wgmma; barrier;
//   3. issue the MMAs of stage kt (one commit group);
//   4. load stage kt + PREFETCH into slot (kt - 2) % RING: last read by the
//      MMAs of step kt - 2 (A) and the transpose of step kt - 2 (raw B),
//      both complete before step kt's first barrier;
//   5. wait for all but the newest MMA group: the MMAs of step kt - 1.
template <int FACTOR, bool AVEC, class LoadA>
__device__ __forceinline__ void mainloop(int8_t* smem, LoadA load_a,
                                         const int8_t* __restrict__ w,
                                         int k_begin, int k_end, int rows,
                                         int N, int n0, bool bvec, int tid,
                                         int (&d)[16]) {
  const int nk = (k_end - k_begin + BK - 1) / BK;
  const int g = tid / 128;
  const LoadB<FACTOR> lb(w, rows, N, n0, tid, bvec);
  int8_t* const a_ring = smem + A_OFF;
  int8_t* const raw_ring = smem + BRAW_OFF;
  int8_t* const bt_ring = smem + BT_OFF;
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0;

  auto load = [&](int j) {  // stage j into its ring slots, one group
    if (j < nk) {
      const int slot = j % RING;
      const int k0 = k_begin + j * BK;
      if constexpr (AVEC) load_a.issue(a_ring + slot * TILE, k0);
      else gather_a(load_a, a_ring + slot * TILE, k0, tid);
      lb.fill(raw_ring + slot * TILE, k0, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j) load(j);

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % RING;
    int8_t* const bt = bt_ring + (kt % BT_RING) * TILE;
    cp_async_wait<PREFETCH - 1>();
    __syncthreads();
    lb.transpose(raw_ring + slot * TILE, bt);
    fence_proxy_async();
    __syncthreads();
    // two k32 MMAs per warpgroup; B of warpgroup g starts 4 g core rows in
    const int8_t* const at = a_ring + slot * TILE;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mma_64x32x32(d, desc(at + 2048 * h), desc(bt + 2048 * h + 512 * g));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    load(kt + PREFETCH);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_operands(d);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
}

// Host side: launches kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(args...)
// after raising its dynamic shared-memory limit; a refusal is returned.
template <class... Params, class... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid,
                          cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace fq
