// K3: fused fully quantized convolution (implicit GEMM), NHWC int8, and
// K3b: the same convolution with the fused max-pool epilogue.
//
// Replaces repro/kernels/fq_conv.py::fq_conv2d (Pallas _kernel and
// fq_conv1d, which is conv2d at kw = 1) and, for K3b, the pool branch of
// that kernel's epilogue (fq_conv.py:356-375). Output rows
// are (b, ho, wo) flattened, columns are output channels, and the
// reduction runs over taps x input channels in the tap-major weight layout
// (row t * Cin + c is tap (t / kw, t % kw), channel c). The activation at
//   (b, ho * sh + th * dh - ph, wo * sw + tw * dw - pw, c)
// is read in place, with a bounds check giving 0: there is no padded copy
// and no patch matrix in device memory. The epilogue is K2's (the shared
// igemm.cuh / epilogue.cuh), so fused and im2col convs stay bit-identical.
//
// All three kernels run on the tensor-core tile loop of K2 (igemm_tc.cuh:
// wgmma m64n32k32 per warpgroup, a 6-stage ring of shared tiles). Their A
// tile comes through one of two loaders, picked by the wrapper per launch:
// with Cin % 16 == 0 (every DarkNet layer, Cin 32 ... 1024) each thread
// cp.asyncs one tap's 16 channels of one pixel, zero-filled for the halo
// (ConvAVec); otherwise (the KWS path's Cin 100 and 45) ConvA gathers byte
// by byte. Both take a row map, which says which conv output pixel a tile
// row is: that is all that tells K3b from K3 before the epilogue.
//
// K3b, pool = (qh, qw): the max of the int32 accumulator over
// non-overlapping (qh, qw) windows of the conv output, floor mode, then
// the epilogue. The epilogue is monotone for scale > 0, so this equals
// conv -> requant -> max-pool of the codes bit for bit, and the unpooled
// tile never reaches device memory. Two forms:
//   * 2 x 2, DarkNet's only pool: tile row r is window g0 + r / 4 at
//     position r % 4 (Pool2Rows), so a 64-row tile is 16 windows x 4
//     positions. In tc::FragMap lane l of warp w holds rows 16 w + l / 4
//     (+ 8): the four positions of a window sit in lanes l % 4 + 4 p +
//     16 (l / 16), p < 4, of one warp, for every accumulator. Two
//     __shfl_xor_sync maxes (lane masks 4 and 8) pool them in registers,
//     with no shared memory and no barrier, and the lanes with p = 0 store
//     (Pool2Map);
//   * any other (qh, qw): the block's 64 rows are 64 pooled outputs; it
//     runs the tile loop once per window position (PassRows) and keeps a
//     running max in the FragMap registers.
// Both do the MACs of the unpooled conv, no more.
//
// Bound: on the KWS path every conv is a few MFLOP over under 1 MB of
// codes (at B = 64), a few microseconds or less at the card's peak rates:
// launch- and latency-bound. On DarkNet-19 at 224 x 224 a layer is 0.03 to
// 0.46 GMAC per image over at most a few MB of codes: the card's int8 rate
// bounds it. The design reads each input byte straight from its NHWC place
// (the im2col path writes and rereads ksize^2 x the activation bytes);
// each thread resolves its output rows to window origins once, in
// registers, and its reduction column to a (tap, channel) offset once per
// K step. What it leaves: TMA gathers, warp specialisation, a tile per
// shape, and the generic pool's separate tile loop per window position.
//
// Split-K, the reference's cin block bc (fq_conv.py:20: its grid reduces
// kh * kw * Cin / bc steps in sequence into one VMEM accumulator). Here
// the 64 x 64 tiles of DarkNet's late convs are fewer than the 132 SMs
// (3 x 3, 512 -> 1024 at 7 x 7: 16 blocks of 72 serial stages at B = 1),
// so where the tile policy (kernels/fq_conv.py::pick_blocks) picks bc < Cin
// for an unpooled int8 conv, the reduction is cut into split = Cin / bc
// slices of kh * kw * bc codes, run by the c = min(split, 8) blocks of one
// thread-block cluster along z (fq_conv_splitk_kernel): rank r sums slices
// r, r + c, ... in its registers, parks its int32 accumulators in its own
// shared memory, and after a cluster barrier finishes 1/c of the tile,
// adding its peers' accumulators through distributed shared memory in rank
// order, then the noise and the epilogue at the global output element.
// One launch, no workspace in device memory. The int32 sum is exact in
// any order, so the codes equal the unsplit kernel's. Packed weights (bc
// fixed to cin_p, the reference's rule) and K3b keep one split.
//
// K5, packed weights (replaces fq_conv.py:330-333 and, for the channel
// padding, :442-452): weights of factor 2 (int4) or 4 (ternary) hold
// taps x cin_p rows, cin padded per tap to a multiple of the factor
// (core/quant.py::pack_im2col_codes), packed factor rows per byte. The
// TPU kernel pads the activations to cin_p channels with a copy; here the
// reduction runs over taps x cin_p, index k -> (t, c) = (k / cin_p,
// k % cin_p), and the gather loads 0 for c >= cin: no activation copy, and
// the pad rows' codes meet zeros. The tile loop decodes each weight byte
// once into the shared B tile (igemm_tc.cuh LoadB). For int8, and for
// every Cin % 16 == 0 (the vector loader), cin_p == cin.
//
// K4, the ADC noise (replaces fq_conv.py:342-355): with a sigma pointer,
// every conv output (b, ho, wo, c) takes the noise.cuh field at its
// unpooled index ((b * Ho + ho) * Wo + wo) * Cout + c, the im2col GEMM's
// row * N + col, before the pool and the epilogue. The pool kernels add it
// to each accumulator at its own unpooled row (FieldMap) and take the max
// of the float32 noisy values. Max commutes with the monotone epilogue,
// so this equals noisy conv -> requant -> code pool. NOISE is a template
// parameter beside DEQUANT and FACTOR, so the clean instantiations carry
// no field code.
#include <climits>
#include <cmath>

#include <cooperative_groups.h>

#include "igemm_tc.cuh"

namespace {

struct ConvShape {
  int B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo;
};

// Row maps: tile row r -> conv output pixel (b, ho, wo), or false for a row
// past the output (it loads 0 and is never stored).

// Unpooled: row m0 + r of the (b, ho, wo)-flattened output.
struct PlainRows {
  int m0, M, hw, Wo;
  __device__ __forceinline__ bool operator()(int r, int& b, int& ho,
                                             int& wo) const {
    const int m = m0 + r;
    if (m >= M) return false;
    b = m / hw;
    const int rem = m - b * hw;
    ho = rem / Wo;
    wo = rem - ho * Wo;
    return true;
  }
};

// Pooled outputs g, (b, hp, wp) flattened over (B, Ho / qh, Wo / qw); the
// position (di, dj) inside window g picks its conv output pixel.
struct Windows {
  int Mp, hwp, Wp, qh, qw;
  __device__ __forceinline__ bool pixel(int g, int di, int dj, int& b,
                                        int& ho, int& wo) const {
    if (g >= Mp) return false;
    b = g / hwp;
    const int rem = g - b * hwp;
    const int hp = rem / Wp;
    ho = hp * qh + di;
    wo = (rem - hp * Wp) * qw + dj;
    return true;
  }
};

// 2 x 2: row r is window g0 + r / 4 at position r % 4 = 2 di + dj.
constexpr int POOL2_WINDOWS = fq::tc::BM / 4;

struct Pool2Rows {
  Windows win;
  int g0;
  __device__ __forceinline__ bool operator()(int r, int& b, int& ho,
                                             int& wo) const {
    const int pos = r & 3;
    return win.pixel(g0 + (r >> 2), pos >> 1, pos & 1, b, ho, wo);
  }
};

// Any pool: row r is window g0 + r at this pass's position (di, dj).
struct PassRows {
  Windows win;
  int g0, di, dj;
  __device__ __forceinline__ bool operator()(int r, int& b, int& ho,
                                             int& wo) const {
    return win.pixel(g0 + r, di, dj, b, ho, wo);
  }
};

// The byte loader: the thread's ROWS output rows, resolved once per block
// to window origins kept in registers; each K step adds one column offset
// (tap, channel). Offsets are int32: the wrapper refuses activations of
// 2^31 bytes or more. The reduction runs over kh * kw taps x Cin_p
// channels, Cin_p being Cin padded to the weights' pack FACTOR; channels
// past Cin load 0, and so do columns at or past K (k_end of the tile
// loop's range).
template <int FACTOR>
struct ConvA {
  const int8_t* x;
  int H, W, Cin, Cin_p, kw, dh, dw, K;
  int off[fq::tc::ROWS];  // ((b * H + h0) * W + w0) * Cin of the origin
  int h0[fq::tc::ROWS];   // ho * sh - ph; far out of range for rows past M
  int w0[fq::tc::ROWS];   // wo * sw - pw
  struct Col { int dy, dx, off; bool ok; };
  template <class Rows>
  __device__ __forceinline__ ConvA(const int8_t* x_, const ConvShape& c,
                                   const Rows& rows, int tid, int k_end)
      : x(x_), H(c.H), W(c.W), Cin(c.Cin),
        Cin_p((c.Cin + FACTOR - 1) / FACTOR * FACTOR), kw(c.kw), dh(c.dh),
        dw(c.dw), K(k_end) {
#pragma unroll
    for (int q = 0; q < fq::tc::ROWS; ++q) {
      int b = 0, ho = 0, wo = 0;
      if (rows(tid / fq::tc::BK + q * fq::tc::ROW_STEP, b, ho, wo)) {
        h0[q] = ho * c.sh - c.ph;
        w0[q] = wo * c.sw - c.pw;
        off[q] = ((b * c.H + h0[q]) * c.W + w0[q]) * c.Cin;
      } else {
        h0[q] = -(1 << 30);
        w0[q] = 0;
        off[q] = 0;
      }
    }
  }
  __device__ __forceinline__ Col col(int k) const {
    if (k >= K) return {0, 0, 0, false};
    const int t = k / Cin_p, ch = k - t * Cin_p;
    if (FACTOR > 1 && ch >= Cin) return {0, 0, 0, false};
    const int dy = (t / kw) * dh, dx = (t % kw) * dw;
    return {dy, dx, (dy * W + dx) * Cin + ch, true};
  }
  __device__ __forceinline__ int8_t at(int q, const Col& c) const {
    const unsigned h = (unsigned)(h0[q] + c.dy), w = (unsigned)(w0[q] + c.dx);
    return (c.ok && h < (unsigned)H && w < (unsigned)W) ? x[off[q] + c.off]
                                                        : (int8_t)0;
  }
};

// The vector loader: thread tid's 16 bytes of tile row tc::vec_row(tid),
// one tap's channels c .. c + 15 of one pixel (Cin % 16 == 0, so a chunk
// never straddles taps and its source is 16-byte aligned), zero-filled for
// the halo, rows past the output and k at or past K (k_end of the tile
// loop's range, which starts at k_begin, a multiple of 16). The row's
// window origin is resolved once, in registers, through the row map as in
// ConvA; the chunk's (tap, channel) is resolved once from k_begin and then
// carried from stage to stage (the stages are issued in order), with no
// division in the loop.
struct ConvAVec {
  const int8_t* x;
  int H, W, Cin, kw, dh, dw, K, r, kc;
  int off, h0, w0;  // as ConvA's, for the thread's one row
  int k, ch, th, tw;  // the next chunk: reduction index, channel, tap
  template <class Rows>
  __device__ __forceinline__ ConvAVec(const int8_t* x_, const ConvShape& c,
                                      const Rows& rows, int tid, int k_begin,
                                      int k_end)
      : x(x_), H(c.H), W(c.W), Cin(c.Cin), kw(c.kw), dh(c.dh), dw(c.dw),
        K(k_end), r(fq::tc::vec_row(tid)), kc(fq::tc::vec_chunk(tid)),
        k(k_begin + 16 * kc) {
    const int t = k / Cin;
    ch = k - t * Cin;
    th = t / kw;
    tw = t - th * kw;
    int b = 0, ho = 0, wo = 0;
    if (rows(r, b, ho, wo)) {
      h0 = ho * c.sh - c.ph;
      w0 = wo * c.sw - c.pw;
      off = ((b * c.H + h0) * c.W + w0) * c.Cin;
    } else {
      h0 = -(1 << 30);
      w0 = 0;
      off = 0;
    }
  }
  __device__ __forceinline__ void next_tap() {
    while (ch >= Cin) {
      ch -= Cin;
      if (++tw == kw) {
        tw = 0;
        ++th;
      }
    }
  }
  // The stage at code k0 = k - 16 kc; then the chunk moves on by BK.
  __device__ __forceinline__ void issue(int8_t* tile, int /*k0*/) {
    const int dy = th * dh, dx = tw * dw;
    const unsigned h = (unsigned)(h0 + dy), w = (unsigned)(w0 + dx);
    const bool ok = k < K && h < (unsigned)H && w < (unsigned)W;
    fq::tc::cp_async16(tile + fq::tc::tile_off(r, 16 * kc),
                       ok ? x + off + (dy * W + dx) * Cin + ch : x,
                       ok ? 16 : 0);
    k += fq::tc::BK;
    ch += fq::tc::BK;
    next_tap();
  }
};

// The reduction length: taps x cin_p, cin padded to the weights' pack
// FACTOR.
template <int FACTOR>
__device__ __forceinline__ int conv_k(const ConvShape& c) {
  return c.kh * c.kw * ((c.Cin + FACTOR - 1) / FACTOR * FACTOR);
}

// The conv's accumulators for the tile rows of the row map `rows` and the
// columns n0 .., in FragMap order, summed over the reduction codes
// [k_begin, k_end) (all of conv_k, or one split of split-K): the tile loop
// with the A loader AVEC picks.
template <int FACTOR, bool AVEC, class Rows>
__device__ __forceinline__ void conv_tile(int8_t* smem, const int8_t* x,
                                          const int8_t* w, const ConvShape& c,
                                          const Rows& rows, int n0, bool bvec,
                                          int tid, int (&acc)[16],
                                          int k_begin, int k_end) {
  const int rows_b = conv_k<FACTOR>(c) / FACTOR;
  if constexpr (AVEC)
    fq::tc::mainloop<FACTOR, true>(
        smem, ConvAVec(x, c, rows, tid, k_begin, k_end), w, k_begin, k_end,
        rows_b, c.Cout, n0, bvec, tid, acc);
  else
    fq::tc::mainloop<FACTOR, false>(
        smem, ConvA<FACTOR>(x, c, rows, tid, k_end), w, k_begin, k_end,
        rows_b, c.Cout, n0, bvec, tid, acc);
}

// K4's map for a pool kernel: FragMap's columns, and for each of the
// thread's two tile rows the noise field's row, the unpooled (b, ho,
// wo)-flattened conv output row of that tile row's pixel, or M = B Ho Wo
// (never drawn) past the windows. Used with m0 = 0.
struct FieldMap {
  static constexpr int N = 16;
  fq::tc::FragMap f;
  int frow[2];
  template <class Rows>
  __device__ __forceinline__ FieldMap(const Rows& rows, const ConvShape& c,
                                      int tid)
      : f(tid) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int b = 0, ho = 0, wo = 0;
      frow[s] = rows(f.row(2 * s), b, ho, wo) ? (b * c.Ho + ho) * c.Wo + wo
                                              : c.B * c.Ho * c.Wo;
    }
  }
  __device__ __forceinline__ int row(int e) const {
    return frow[(e / 2) % 2];
  }
  __device__ __forceinline__ int col(int e) const { return f.col(e); }
};

// The 2 x 2 kernel's pooled outputs after the lane maxes: element e of
// lane l of warp w is window 4 w + l / 16 + 2 ((e / 2) % 2) of the tile
// (FragMap's row / 4), at FragMap's column.
struct Pool2Map {
  static constexpr int N = 16;
  fq::tc::FragMap f;
  int r;
  __device__ __forceinline__ explicit Pool2Map(int tid)
      : f(tid), r(4 * ((tid % 128) / 32) + (tid % 32) / 16) {}
  __device__ __forceinline__ int row(int e) const {
    return r + 2 * ((e / 2) % 2);
  }
  __device__ __forceinline__ int col(int e) const { return f.col(e); }
};

__device__ __forceinline__ int lane_max(int v, int mask) {
  return max(v, __shfl_xor_sync(0xffffffffu, v, mask));
}
__device__ __forceinline__ float lane_max(float v, int mask) {
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, mask));
}

template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, void* __restrict__ out,
               ConvShape c, int lo, int n_out, bool bvec, fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int M = c.B * c.Ho * c.Wo;
  const int m0 = blockIdx.x * fq::tc::BM, n0 = blockIdx.y * fq::tc::BN;
  int acc[16];
  conv_tile<FACTOR, AVEC>(smem, x, w, c, PlainRows{m0, M, c.Ho * c.Wo, c.Wo},
                          n0, bvec, tid, acc, 0, conv_k<FACTOR>(c));
  // output row m of the (b, ho, wo)-flattened conv is the field's row
  const fq::tc::FragMap map(tid);
  if constexpr (NOISE) {
    float v[16];
    fq::noisy_tile(v, acc, fq::Noise::load(na), M, c.Cout, m0, n0, map);
    fq::store<DEQUANT>(out, v, *scale, lo, n_out, M, c.Cout, m0, n0, map);
  } else {
    fq::store<DEQUANT>(out, acc, *scale, lo, n_out, M, c.Cout, m0, n0, map);
  }
}

// K3, split-K, int8 weights: the blocks of one output tile are one
// cluster of c = gridDim.z <= 8 along z. Rank r sums the slices z = r, r +
// c, ... < split of the reduction, each kspan codes [z kspan, (z + 1)
// kspan) (one cin block of bc channels over all kh * kw taps, kspan = kh kw
// bc), parks its accumulators in its shared memory (the stage buffers,
// RED_LD-strided rows), and after a cluster barrier finishes the tile's
// groups of 4 columns [r 1024 / c, (r + 1) 1024 / c): the sum of every
// rank's accumulators in rank order (one 16-byte read a rank, all in
// flight together), the noise.cuh field at the global index when NOISE,
// the shared epilogue. A second barrier keeps each block's shared memory
// alive until its peers have read it.
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int RED_LD = fq::tc::BN + 4;  // a parked row, 16-byte aligned
static_assert(fq::tc::BM * RED_LD * 4 <= fq::tc::SMEM_BYTES, "parked tile");

template <bool DEQUANT, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_conv_splitk_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, void* __restrict__ out,
                      ConvShape c, int split, int kspan, int lo, int n_out,
                      bool bvec, fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int M = c.B * c.Ho * c.Wo, K = conv_k<1>(c);
  const int m0 = blockIdx.x * fq::tc::BM, n0 = blockIdx.y * fq::tc::BN;
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
  for (int z = rank; z < split; z += ranks) {
    // mainloop ends with this warpgroup's MMAs complete only: the next
    // slice's prologue cp.asyncs into ring slots the other's may still read
    if (z != rank) __syncthreads();
    int part[16];
    conv_tile<1, AVEC>(smem, x, w, c, PlainRows{m0, M, c.Ho * c.Wo, c.Wo},
                       n0, bvec, tid, part, z * kspan,
                       min(K, (z + 1) * kspan));
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += part[e];
  }
  __syncthreads();  // every MMA of the block has read its stage buffers
  int* const parked = reinterpret_cast<int*>(smem);
  const fq::tc::FragMap map(tid);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    parked[map.row(e) * RED_LD + map.col(e)] = acc[e];
  cluster.sync();
  const float sc = *scale;
  fq::Noise nz{};
  if constexpr (NOISE) nz = fq::Noise::load(na);
  constexpr int QUADS = fq::tc::BM * fq::tc::BN / 4;
  const int end = (rank + 1) * QUADS / ranks;
  for (int i = rank * QUADS / ranks + tid; i < end; i += fq::tc::THREADS) {
    const int r = i / (fq::tc::BN / 4), col = 4 * (i % (fq::tc::BN / 4));
    const int m = m0 + r;
    if (m >= M || n0 + col >= c.Cout) continue;
    int4 part[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
      if (p < ranks)
        part[p] = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(parked, p) + r * RED_LD + col);
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) {
      if (p < ranks) {
        sum[0] += part[p].x;
        sum[1] += part[p].y;
        sum[2] += part[p].z;
        sum[3] += part[p].w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + col + e;
      if (n >= c.Cout) break;
      const long long o = (long long)m * c.Cout + n;
      if constexpr (NOISE)
        fq::put<DEQUANT>(out, o, nz.add(sum[e], m, c.Cout, n), sc, lo,
                         n_out);
      else
        fq::put<DEQUANT>(out, o, sum[e], sc, lo, n_out);
    }
  }
  cluster.sync();
}

// K3b, 2 x 2: the block's 64 rows are windows g0 .. g0 + 15 x 4 positions
// (Pool2Rows); the max over a window's positions runs across lanes.
template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_conv_pool2_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale, void* __restrict__ out,
                     ConvShape c, Windows win, int lo, int n_out, bool bvec,
                     fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * POOL2_WINDOWS, n0 = blockIdx.y * fq::tc::BN;
  const Pool2Rows rows{win, g0};
  int acc[16];
  conv_tile<FACTOR, AVEC>(smem, x, w, c, rows, n0, bvec, tid, acc, 0,
                          conv_k<FACTOR>(c));
  // a window's 4 positions are all inside the output or all past it, so
  // the 0 that noisy_tile gives past it meets only rows never stored
  std::conditional_t<NOISE, float, int> v[16];
  if constexpr (NOISE) {
    fq::noisy_tile(v, acc, fq::Noise::load(na), c.B * c.Ho * c.Wo, c.Cout,
                   0, n0, FieldMap(rows, c, tid));
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = acc[e];
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = lane_max(lane_max(v[e], 4), 8);
  if ((tid % 32) / 4 % 4 == 0)
    fq::store<DEQUANT>(out, v, *scale, lo, n_out, win.Mp, c.Cout, g0, n0,
                       Pool2Map(tid));
}

// K3b, any (qh, qw): the block's 64 rows are 64 windows; one tile loop per
// window position, and a running max in the FragMap registers, int32 on
// the clean path and float32 (the noisy accumulators) with NOISE.
template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_conv_pool_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out,
                    ConvShape c, Windows win, int lo, int n_out, bool bvec,
                    fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * fq::tc::BM, n0 = blockIdx.y * fq::tc::BN;
  fq::Noise nz{};
  if constexpr (NOISE) nz = fq::Noise::load(na);
  std::conditional_t<NOISE, float, int> mx[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if constexpr (NOISE) mx[e] = -INFINITY;
    else mx[e] = INT_MIN;
  }
  for (int di = 0; di < win.qh; ++di) {
    for (int dj = 0; dj < win.qw; ++dj) {
      // mainloop ends with wgmma.wait_group 0 of this warpgroup only: the
      // next pass's prologue cp.asyncs into ring slots that the other
      // warpgroup's last MMAs may still read
      if (di + dj > 0) __syncthreads();
      const PassRows rows{win, g0, di, dj};
      int acc[16];
      conv_tile<FACTOR, AVEC>(smem, x, w, c, rows, n0, bvec, tid, acc, 0,
                              conv_k<FACTOR>(c));
      if constexpr (NOISE) {
        float v[16];
        fq::noisy_tile(v, acc, nz, c.B * c.Ho * c.Wo, c.Cout, 0, n0,
                       FieldMap(rows, c, tid));
#pragma unroll
        for (int e = 0; e < 16; ++e) mx[e] = fmaxf(mx[e], v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) mx[e] = max(mx[e], acc[e]);
      }
    }
  }
  fq::store<DEQUANT>(out, mx, *scale, lo, n_out, win.Mp, c.Cout, g0, n0,
                     fq::tc::FragMap(tid));
}

template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
cudaError_t launch_pool(const int8_t* x, const int8_t* w, const float* scale,
                        void* out, const ConvShape& c, const Windows& win,
                        int lo, int n_out, bool bvec, const fq::NoiseArgs& na,
                        cudaStream_t st) {
  const unsigned gy = (c.Cout + fq::tc::BN - 1) / fq::tc::BN;
  if (win.qh == 2 && win.qw == 2)
    return fq::tc::launch(
        fq_conv_pool2_kernel<DEQUANT, FACTOR, NOISE, AVEC>,
        dim3((win.Mp + POOL2_WINDOWS - 1) / POOL2_WINDOWS, gy), st, x, w,
        scale, out, c, win, lo, n_out, bvec, na);
  return fq::tc::launch(fq_conv_pool_kernel<DEQUANT, FACTOR, NOISE, AVEC>,
                        dim3((win.Mp + fq::tc::BM - 1) / fq::tc::BM, gy), st,
                        x, w, scale, out, c, win, lo, n_out, bvec, na);
}

}  // namespace

// factor: codes per weight byte (1 int8, 2 int4, 4 ternary); w holds
// kh * kw * cin_p / factor rows. avec: A's vector loader (Cin % 16 == 0, x
// 16-byte aligned), else the byte gather; bvec: B's 16-byte cp.async
// (Cout % 16 == 0, w 16-byte aligned), else masked byte loads. sigma
// (float32) and seed (uint32) are device scalars, or null for the clean
// epilogue; chunks >= 1 with noise.
extern "C" int fq_conv2d_s8(const void* x, const void* w, const void* scale,
                            void* out, const void* sigma, const void* seed,
                            int B, int H, int W, int Cin, int Cout, int kh,
                            int kw, int sh, int sw, int ph, int pw, int dh,
                            int dw, int Ho, int Wo, int factor, int dequant,
                            int lo, int n_out, int chunks, int avec, int bvec,
                            void* stream) {
  const ConvShape c{B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo};
  const int M = B * Ho * Wo;
  cudaError_t err = cudaSuccess;
  if (sigma && chunks < 1) return (int)cudaErrorInvalidValue;
  if ((avec && ((uintptr_t)x % 16 || Cin % 16)) ||
      (bvec && ((uintptr_t)w % 16 || Cout % 16)))
    return (int)cudaErrorInvalidValue;
  if (M > 0 && Cout > 0) {
    dim3 grid((M + fq::tc::BM - 1) / fq::tc::BM,
              (Cout + fq::tc::BN - 1) / fq::tc::BN);
    cudaStream_t st = (cudaStream_t)stream;
    const int8_t *xs = (const int8_t*)x, *ws = (const int8_t*)w;
    const float* sc = (const float*)scale;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    const cudaError_t bad = fq::with_factor(factor, [&](auto f) {
      constexpr int F = decltype(f)::value;
      fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
        constexpr bool DQ = decltype(dq)::value, NZ = decltype(nz)::value;
        err = avec ? fq::tc::launch(fq_conv_kernel<DQ, F, NZ, true>, grid,
                                    st, xs, ws, sc, out, c, lo, n_out,
                                    bvec != 0, na)
                   : fq::tc::launch(fq_conv_kernel<DQ, F, NZ, false>, grid,
                                    st, xs, ws, sc, out, c, lo, n_out,
                                    bvec != 0, na);
      });
    });
    if (bad != cudaSuccess) err = bad;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// K3, split-K (int8 weights): the conv as split slices of kspan reduction
// codes, slice z over [z kspan, (z + 1) kspan), reduced in a cluster of
// min(split, 8) blocks a tile (fq_conv_splitk_kernel); the output, sigma,
// seed, dequant, lo, n_out, chunks, avec and bvec as fq_conv2d_s8's, and
// kspan % 16 == 0 with avec.
extern "C" int fq_conv2d_splitk_s8(const void* x, const void* w,
                                   const void* scale, void* out,
                                   const void* sigma, const void* seed, int B,
                                   int H, int W, int Cin, int Cout, int kh,
                                   int kw, int sh, int sw, int ph, int pw,
                                   int dh, int dw, int Ho, int Wo, int split,
                                   int kspan, int dequant, int lo, int n_out,
                                   int chunks, int avec, int bvec,
                                   void* stream) {
  const ConvShape c{B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo};
  const int M = B * Ho * Wo;
  if (split < 1 || kspan < 1 || (long long)split * kspan < kh * kw * Cin ||
      (sigma && chunks < 1) ||
      (avec && ((uintptr_t)x % 16 || Cin % 16 || kspan % 16)) ||
      (bvec && ((uintptr_t)w % 16 || Cout % 16)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (M > 0 && Cout > 0) {
    const unsigned ranks = split < MAX_CLUSTER ? split : MAX_CLUSTER;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((M + fq::tc::BM - 1) / fq::tc::BM,
                       (Cout + fq::tc::BN - 1) / fq::tc::BN, ranks);
    cfg.blockDim = dim3(fq::tc::THREADS);
    cfg.dynamicSmemBytes = fq::tc::SMEM_BYTES;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = ranks;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int8_t *xs = (const int8_t*)x, *wt = (const int8_t*)w;
    const float* sc = (const float*)scale;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
      constexpr bool DQ = decltype(dq)::value, NZ = decltype(nz)::value;
      const auto go = [&](auto kernel) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            fq::tc::SMEM_BYTES);
        if (err == cudaSuccess)
          err = cudaLaunchKernelEx(&cfg, kernel, xs, wt, sc, out, c, split,
                                   kspan, lo, n_out, bvec != 0, na);
      };
      if (avec) go(fq_conv_splitk_kernel<DQ, NZ, true>);
      else go(fq_conv_splitk_kernel<DQ, NZ, false>);
    });
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// K3b: (Ho, Wo) is the conv output; the output is (B, Ho / qh, Wo / qw,
// Cout). avec and bvec as fq_conv2d_s8's.
extern "C" int fq_conv2d_pool_s8(const void* x, const void* w,
                                 const void* scale, void* out,
                                 const void* sigma, const void* seed, int B,
                                 int H, int W, int Cin, int Cout, int kh,
                                 int kw, int sh, int sw, int ph, int pw,
                                 int dh, int dw, int Ho, int Wo, int qh,
                                 int qw, int factor, int dequant, int lo,
                                 int n_out, int chunks, int avec, int bvec,
                                 void* stream) {
  const ConvShape c{B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo};
  const int Hp = Ho / qh, Wp = Wo / qw;
  const Windows win{B * Hp * Wp, Hp * Wp, Wp, qh, qw};
  cudaError_t err = cudaSuccess;
  if (sigma && chunks < 1) return (int)cudaErrorInvalidValue;
  if ((avec && ((uintptr_t)x % 16 || Cin % 16)) ||
      (bvec && ((uintptr_t)w % 16 || Cout % 16)))
    return (int)cudaErrorInvalidValue;
  if (win.Mp > 0 && Cout > 0) {
    const int8_t *xs = (const int8_t*)x, *ws = (const int8_t*)w;
    const float* sc = (const float*)scale;
    cudaStream_t st = (cudaStream_t)stream;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    const cudaError_t bad = fq::with_factor(factor, [&](auto f) {
      constexpr int F = decltype(f)::value;
      fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
        constexpr bool DQ = decltype(dq)::value, NZ = decltype(nz)::value;
        err = avec ? launch_pool<DQ, F, NZ, true>(xs, ws, sc, out, c, win, lo,
                                                 n_out, bvec != 0, na, st)
                   : launch_pool<DQ, F, NZ, false>(xs, ws, sc, out, c, win,
                                                  lo, n_out, bvec != 0, na,
                                                  st);
      });
    });
    if (bad != cudaSuccess) err = bad;
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
