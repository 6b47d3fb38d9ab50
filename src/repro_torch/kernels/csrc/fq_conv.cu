// K3: fused fully quantized convolution (implicit GEMM), NHWC int8.
//
// Replaces repro/kernels/fq_conv.py::fq_conv2d (Pallas _kernel, its
// pick_blocks and fq_conv1d, which is conv2d at kw = 1). Output rows are
// (b, ho, wo) flattened, columns are output channels, and the reduction
// runs over taps x input channels in the tap-major weight layout (row
// t * Cin + c is tap (t / kw, t % kw), channel c). The activation at
//   (b, ho * sh + th * dh - ph, wo * sw + tw * dw - pw, c)
// is read in place, with a bounds check giving 0: there is no padded copy
// and no patch matrix in device memory. The epilogue is K2's (the shared
// igemm.cuh / epilogue.cuh), so fused and im2col convs stay bit-identical.
//
// Bound: on the KWS path every conv is a few MFLOP over under 1 MB of
// codes (at B = 64), a few microseconds or less at the card's peak rates:
// launch- and latency-bound. The design reads each input byte straight
// from its NHWC place (the im2col path writes and rereads ksize x the
// activation bytes); each thread resolves its output rows to window
// origins once, in registers, and its reduction column to a (tap, channel)
// offset once per K step, so a gathered byte costs one add and a bounds
// test. Tensor-core mma and TMA gathers are left for the PRs that make it
// fast.
#include "igemm.cuh"

namespace {

struct ConvShape {
  int B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo;
};

// The thread's ROWS output rows, resolved once per block to window origins
// kept in registers; each K step adds one column offset (tap, channel).
// Offsets are int32: the wrapper refuses activations of 2^31 bytes or more.
struct ConvA {
  const int8_t* x;
  int H, W, Cin, kw, dh, dw, K;
  int off[fq::ROWS];  // ((b * H + h0) * W + w0) * Cin of the window origin
  int h0[fq::ROWS];   // ho * sh - ph; far out of range for rows past M
  int w0[fq::ROWS];   // wo * sw - pw
  struct Col { int dy, dx, off; bool ok; };
  __device__ __forceinline__ ConvA(const int8_t* x_, const ConvShape& c,
                                   int m0, int tid)
      : x(x_), H(c.H), W(c.W), Cin(c.Cin), kw(c.kw), dh(c.dh), dw(c.dw),
        K(c.kh * c.kw * c.Cin) {
    const int M = c.B * c.Ho * c.Wo, hw = c.Ho * c.Wo;
#pragma unroll
    for (int q = 0; q < fq::ROWS; ++q) {
      const int m = m0 + tid / fq::BK + q * fq::ROW_STEP;
      if (m < M) {
        const int b = m / hw, rem = m - b * hw;
        const int ho = rem / c.Wo, wo = rem - ho * c.Wo;
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
    const int t = k / Cin, ch = k - t * Cin;
    const int dy = (t / kw) * dh, dx = (t % kw) * dw;
    return {dy, dx, (dy * W + dx) * Cin + ch, true};
  }
  __device__ __forceinline__ int8_t at(int q, const Col& c) const {
    const unsigned h = (unsigned)(h0[q] + c.dy), w = (unsigned)(w0[q] + c.dx);
    return (c.ok && h < (unsigned)H && w < (unsigned)W) ? x[off[q] + c.off]
                                                        : (int8_t)0;
  }
};

template <bool DEQUANT>
__global__ void __launch_bounds__(fq::THREADS)
fq_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, void* __restrict__ out,
               ConvShape c, int lo, int n_out) {
  __shared__ fq::Tiles s;
  const int tid = threadIdx.x;
  const int M = c.B * c.Ho * c.Wo;
  const int m0 = blockIdx.x * fq::BM, n0 = blockIdx.y * fq::BN;
  int acc[4][4] = {};
  const ConvA load_a(x, c, m0, tid);
  fq::mainloop(s, load_a, w, load_a.K, c.Cout, n0, tid, acc);
  fq::store<DEQUANT>(out, acc, *scale, lo, n_out, M, c.Cout, m0, n0, tid);
}

}  // namespace

extern "C" int fq_conv2d_s8(const void* x, const void* w, const void* scale,
                            void* out, int B, int H, int W, int Cin, int Cout,
                            int kh, int kw, int sh, int sw, int ph, int pw,
                            int dh, int dw, int Ho, int Wo, int dequant,
                            int lo, int n_out, void* stream) {
  const ConvShape c{B, H, W, Cin, Cout, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo};
  const int M = B * Ho * Wo;
  if (M > 0 && Cout > 0) {
    dim3 grid((M + fq::BM - 1) / fq::BM, (Cout + fq::BN - 1) / fq::BN);
    cudaStream_t st = (cudaStream_t)stream;
    if (dequant)
      fq_conv_kernel<true><<<grid, fq::THREADS, 0, st>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)scale, out, c, lo,
          n_out);
    else
      fq_conv_kernel<false><<<grid, fq::THREADS, 0, st>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)scale, out, c, lo,
          n_out);
  }
  return (int)cudaGetLastError();
}
