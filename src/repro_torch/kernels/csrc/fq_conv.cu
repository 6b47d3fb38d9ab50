// K3: fused fully quantized convolution (implicit GEMM), NHWC int8, and
// K3b: the same convolution with the fused max-pool epilogue.
//
// Replaces repro/kernels/fq_conv.py::fq_conv2d (Pallas _kernel, its
// pick_blocks and fq_conv1d, which is conv2d at kw = 1) and, for K3b, the
// pool branch of that kernel's epilogue (fq_conv.py:356-375). Output rows
// are (b, ho, wo) flattened, columns are output channels, and the
// reduction runs over taps x input channels in the tap-major weight layout
// (row t * Cin + c is tap (t / kw, t % kw), channel c). The activation at
//   (b, ho * sh + th * dh - ph, wo * sw + tw * dw - pw, c)
// is read in place, with a bounds check giving 0: there is no padded copy
// and no patch matrix in device memory. The epilogue is K2's (the shared
// igemm.cuh / epilogue.cuh), so fused and im2col convs stay bit-identical.
//
// K3b, pool = (qh, qw): the max of the int32 accumulator over
// non-overlapping (qh, qw) windows of the conv output, floor mode, then
// the epilogue. The epilogue is monotone for scale > 0, so this equals
// conv -> requant -> max-pool of the codes bit for bit, and the unpooled
// tile never reaches device memory. Two forms:
//   * 2 x 2, DarkNet's only pool: the block's 64 GEMM rows are 16 pooled
//     outputs x 4 window positions (row r is window r % 16 at position
//     r / 16), so thread ty holds all four accumulators of window ty in
//     acc[0..3][j] and the pool is three register maxes;
//   * any other (qh, qw): the block's 64 rows are 64 pooled outputs; it
//     runs the tile loop once per window position and keeps a running max
//     in registers. Both do the MACs of the unpooled conv, no more.
//
// K3 runs on the tensor-core tile loop of K2 (igemm_tc.cuh: wgmma
// m64n32k32 per warpgroup, a 6-stage ring of shared tiles). Its A tile
// comes through one of two loaders, picked by the wrapper per launch: with
// Cin % 16 == 0 (every DarkNet layer, Cin 32 ... 1024) each thread
// cp.asyncs one tap's 16 channels of one pixel, zero-filled for the halo;
// otherwise (the KWS path's Cin 100 and 45) ConvA gathers byte by byte.
// K3b keeps the dp4a loop (igemm.cuh), whose thread map its 2 x 2 pool
// reads.
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
// shape (the 16-block deep layers at B = 1) and K3b's pool on wgmma.
//
// K5, packed weights (replaces fq_conv.py:330-333 and, for the channel
// padding, :442-452): weights of factor 2 (int4) or 4 (ternary) hold
// taps x cin_p rows, cin padded per tap to a multiple of the factor
// (core/quant.py::pack_im2col_codes), packed factor rows per byte. The
// TPU kernel pads the activations to cin_p channels with a copy; here the
// reduction runs over taps x cin_p, index k -> (t, c) = (k / cin_p,
// k % cin_p), and the gather loads 0 for c >= cin: no activation copy, and
// the pad rows' codes meet zeros. The shared tile loops decode each
// weight byte once into the shared B tile (igemm_tc.cuh LoadB for K3,
// igemm.cuh load_b_tile for K3b). For int8,
// cin_p == cin and the gather is the int8 one.
//
// K4, the ADC noise (replaces fq_conv.py:342-355): with a sigma pointer,
// every conv output (b, ho, wo, c) takes the noise.cuh field at its
// unpooled index ((b * Ho + ho) * Wo + wo) * Cout + c, the im2col GEMM's
// row * N + col, before the pool and the epilogue. The pool kernels then
// keep a float32 running max of the noisy accumulators: in the 2 x 2
// kernel each of a window's 4 positions has its own row, in the generic
// one each pass's position gives the row (PassRows). Max commutes with
// the monotone epilogue, so this equals noisy conv -> requant -> code
// pool. NOISE is a template parameter beside DEQUANT and FACTOR, so the
// clean instantiations carry no field code.
#include <climits>
#include <cmath>

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

// 2 x 2: row r is window g0 + r % POOL2_WINDOWS at position r / POOL2_WINDOWS.
constexpr int POOL2_WINDOWS = fq::BM / 4;
static_assert(POOL2_WINDOWS == 16,
              "thread ty must own rows ty + 16 i, i < 4 (igemm.cuh)");

struct Pool2Rows {
  Windows win;
  int g0;
  __device__ __forceinline__ bool operator()(int r, int& b, int& ho,
                                             int& wo) const {
    const int pos = r / POOL2_WINDOWS;
    return win.pixel(g0 + r % POOL2_WINDOWS, pos >> 1, pos & 1, b, ho, wo);
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

// The thread's ROWS output rows, resolved once per block to window origins
// kept in registers; each K step adds one column offset (tap, channel).
// Offsets are int32: the wrapper refuses activations of 2^31 bytes or more.
// The reduction runs over kh * kw taps x Cin_p channels, Cin_p being Cin
// padded to the weights' pack FACTOR; channels past Cin load 0.
template <int FACTOR>
struct ConvA {
  const int8_t* x;
  int H, W, Cin, Cin_p, kw, dh, dw, K;
  int off[fq::ROWS];  // ((b * H + h0) * W + w0) * Cin of the window origin
  int h0[fq::ROWS];   // ho * sh - ph; far out of range for rows past M
  int w0[fq::ROWS];   // wo * sw - pw
  struct Col { int dy, dx, off; bool ok; };
  template <class Rows>
  __device__ __forceinline__ ConvA(const int8_t* x_, const ConvShape& c,
                                   const Rows& rows, int tid)
      : x(x_), H(c.H), W(c.W), Cin(c.Cin),
        Cin_p((c.Cin + FACTOR - 1) / FACTOR * FACTOR), kw(c.kw), dh(c.dh),
        dw(c.dw), K(c.kh * c.kw * Cin_p) {
#pragma unroll
    for (int q = 0; q < fq::ROWS; ++q) {
      int b = 0, ho = 0, wo = 0;
      if (rows(tid / fq::BK + q * fq::ROW_STEP, b, ho, wo)) {
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
// the halo, rows past M and k past K. The row's window origin is resolved
// once, in registers, as in ConvA; the chunk's (tap, channel) is carried
// from stage to stage (the stages are issued in order), with no division
// in the loop.
struct ConvAVec {
  const int8_t* x;
  int H, W, Cin, kw, dh, dw, K, r, kc;
  int off, h0, w0;  // as ConvA's, for the thread's one row
  int k, ch, th, tw;  // the next chunk: reduction index, channel, tap
  __device__ __forceinline__ ConvAVec(const int8_t* x_, const ConvShape& c,
                                      int m0, int tid)
      : x(x_), H(c.H), W(c.W), Cin(c.Cin), kw(c.kw), dh(c.dh), dw(c.dw),
        K(c.kh * c.kw * c.Cin), r(fq::tc::vec_row(tid)),
        kc(fq::tc::vec_chunk(tid)), k(16 * kc), ch(16 * kc), th(0), tw(0) {
    int b = 0, ho = 0, wo = 0;
    if (PlainRows{m0, c.B * c.Ho * c.Wo, c.Ho * c.Wo, c.Wo}(r, b, ho, wo)) {
      h0 = ho * c.sh - c.ph;
      w0 = wo * c.sw - c.pw;
      off = ((b * c.H + h0) * c.W + w0) * c.Cin;
    } else {
      h0 = -(1 << 30);
      w0 = 0;
      off = 0;
    }
    next_tap();
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

template <bool DEQUANT, int FACTOR, bool NOISE, bool AVEC>
__global__ void __launch_bounds__(fq::tc::THREADS)
fq_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, void* __restrict__ out,
               ConvShape c, int lo, int n_out, bool bvec, fq::NoiseArgs na) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int M = c.B * c.Ho * c.Wo;
  const int m0 = blockIdx.x * fq::tc::BM, n0 = blockIdx.y * fq::tc::BN;
  // taps x cin_p reduction rows, cin padded to the weights' pack FACTOR
  const int K = c.kh * c.kw * ((c.Cin + FACTOR - 1) / FACTOR * FACTOR);
  int acc[16];
  if constexpr (AVEC)
    fq::tc::mainloop<FACTOR, true>(smem, ConvAVec(x, c, m0, tid), w, K,
                                   K / FACTOR, c.Cout, n0, bvec, tid, acc);
  else
    fq::tc::mainloop<FACTOR, false>(
        smem, ConvA<FACTOR>(x, c, PlainRows{m0, M, c.Ho * c.Wo, c.Wo}, tid),
        w, K, K / FACTOR, c.Cout, n0, bvec, tid, acc);
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

// The unpooled (b, ho, wo)-flattened row of window g's position (di, dj),
// the ADC-noise field's row; false past the windows.
__device__ __forceinline__ bool field_row(const Windows& win,
                                          const ConvShape& c, int g, int di,
                                          int dj, int& row) {
  int b, ho, wo;
  if (!win.pixel(g, di, dj, b, ho, wo)) return false;
  row = (b * c.Ho + ho) * c.Wo + wo;
  return true;
}

// K3b, 2 x 2: thread (tx, ty) holds rows ty + 16 i, the four positions of
// window g0 + ty, and columns tx + 16 j.
template <bool DEQUANT, int FACTOR, bool NOISE>
__global__ void __launch_bounds__(fq::THREADS)
fq_conv_pool2_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale, void* __restrict__ out,
                     ConvShape c, Windows win, int lo, int n_out,
                     fq::NoiseArgs na) {
  __shared__ fq::Tiles s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g0 = blockIdx.x * POOL2_WINDOWS, n0 = blockIdx.y * fq::BN;
  int acc[4][4] = {};
  const ConvA<FACTOR> load_a(x, c, Pool2Rows{win, g0}, tid);
  fq::mainloop<FACTOR>(s, load_a, w, load_a.K, load_a.K / FACTOR, c.Cout, n0,
                       tid, acc);
  const int g = g0 + ty;
  if (g >= win.Mp) return;
  const float sc = *scale;
  if constexpr (NOISE) {
    const fq::Noise nz = fq::Noise::load(na);
    int row[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) field_row(win, c, g, i >> 1, i & 1, row[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= c.Cout) continue;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m = fmaxf(m, nz.add(acc[i][j], row[i], c.Cout, n));
      fq::put<DEQUANT>(out, (long long)g * c.Cout + n, m, sc, lo, n_out);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= c.Cout) continue;
      const int m = max(max(acc[0][j], acc[1][j]), max(acc[2][j], acc[3][j]));
      fq::put<DEQUANT>(out, (long long)g * c.Cout + n, m, sc, lo, n_out);
    }
  }
}

// K3b, any (qh, qw): one tile loop per window position, running max.
// The running max is int32 on the clean path and float32 (the noisy
// accumulators) with NOISE.
template <bool DEQUANT, int FACTOR, bool NOISE>
__global__ void __launch_bounds__(fq::THREADS)
fq_conv_pool_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out,
                    ConvShape c, Windows win, int lo, int n_out,
                    fq::NoiseArgs na) {
  using Acc = std::conditional_t<NOISE, float, int>;
  __shared__ fq::Tiles s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g0 = blockIdx.x * fq::BM, n0 = blockIdx.y * fq::BN;
  fq::Noise nz{};
  if constexpr (NOISE) nz = fq::Noise::load(na);
  Acc mx[16];  // mx[4 i + j]: TileMap's element of acc[i][j]
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if constexpr (NOISE) mx[e] = -INFINITY;
    else mx[e] = INT_MIN;
  }
  for (int di = 0; di < win.qh; ++di) {
    for (int dj = 0; dj < win.qw; ++dj) {
      int acc[4][4] = {};
      const ConvA<FACTOR> load_a(x, c, PassRows{win, g0, di, dj}, tid);
      fq::mainloop<FACTOR>(s, load_a, w, load_a.K, load_a.K / FACTOR, c.Cout,
                           n0, tid, acc);
      if constexpr (NOISE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int row;
          if (!field_row(win, c, g0 + ty + 16 * i, di, dj, row)) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < c.Cout)
              mx[4 * i + j] = fmaxf(mx[4 * i + j],
                                    nz.add(acc[i][j], row, c.Cout, n));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mx[4 * i + j] = max(mx[4 * i + j], acc[i][j]);
      }
    }
  }
  fq::store<DEQUANT>(out, mx, *scale, lo, n_out, win.Mp, c.Cout, g0, n0,
                     fq::TileMap(tid));
}

template <bool DEQUANT, int FACTOR, bool NOISE>
void launch_pool(const int8_t* x, const int8_t* w, const float* scale,
                 void* out, const ConvShape& c, const Windows& win, int lo,
                 int n_out, const fq::NoiseArgs& na, cudaStream_t st) {
  const unsigned gy = (c.Cout + fq::BN - 1) / fq::BN;
  if (win.qh == 2 && win.qw == 2) {
    dim3 grid((win.Mp + POOL2_WINDOWS - 1) / POOL2_WINDOWS, gy);
    fq_conv_pool2_kernel<DEQUANT, FACTOR, NOISE>
        <<<grid, fq::THREADS, 0, st>>>(x, w, scale, out, c, win, lo, n_out,
                                       na);
  } else {
    dim3 grid((win.Mp + fq::BM - 1) / fq::BM, gy);
    fq_conv_pool_kernel<DEQUANT, FACTOR, NOISE>
        <<<grid, fq::THREADS, 0, st>>>(x, w, scale, out, c, win, lo, n_out,
                                       na);
  }
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

// K3b: (Ho, Wo) is the conv output; the output is (B, Ho / qh, Wo / qw, Cout).
extern "C" int fq_conv2d_pool_s8(const void* x, const void* w,
                                 const void* scale, void* out,
                                 const void* sigma, const void* seed, int B,
                                 int H, int W, int Cin, int Cout, int kh,
                                 int kw, int sh, int sw, int ph, int pw,
                                 int dh, int dw, int Ho, int Wo, int qh,
                                 int qw, int factor, int dequant, int lo,
                                 int n_out, int chunks, void* stream) {
  const ConvShape c{B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo};
  const int Hp = Ho / qh, Wp = Wo / qw;
  const Windows win{B * Hp * Wp, Hp * Wp, Wp, qh, qw};
  cudaError_t err = cudaSuccess;
  if (sigma && chunks < 1) return (int)cudaErrorInvalidValue;
  if (win.Mp > 0 && Cout > 0) {
    const int8_t *xs = (const int8_t*)x, *ws = (const int8_t*)w;
    const float* sc = (const float*)scale;
    cudaStream_t st = (cudaStream_t)stream;
    const fq::NoiseArgs na{(const float*)sigma, (const uint32_t*)seed, chunks};
    err = fq::with_factor(factor, [&](auto f) {
      constexpr int F = decltype(f)::value;
      fq::with_flags(dequant, sigma != nullptr, [&](auto dq, auto nz) {
        launch_pool<decltype(dq)::value, F, decltype(nz)::value>(
            xs, ws, sc, out, c, win, lo, n_out, na, st);
      });
    });
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
