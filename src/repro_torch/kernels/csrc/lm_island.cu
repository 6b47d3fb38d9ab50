// The integer LM's attention island: masked GQA softmax attention over the
// int8 code-domain KV cache.
//
// Replaces no TPU kernel: repro/models/fq_lm.py::_attention (fq_lm.py:
// 202-218) is plain jnp einsum / softmax in the reference. It is a kernel
// here because its outputs must not depend on the shape of the call (the
// reference's tests hold prefill(T) + decode == prefill(T + 1) and batched
// == unbatched decode bit for bit), and cuBLAS and PyTorch's reductions
// pick their summation order from the whole shape. This kernel fixes the
// order, and kernels/lm_island.py::lm_island_plain repeats it in
// elementwise PyTorch ops; the two are bit-identical. Every float32 step is
// one IEEE operation rounded to nearest (__f*_rn, and the library builds
// with --fmad=false: no contraction), the exp is core/quant.py::exp (XLA's
// float32 exp: Cephes with each multiply-add fused, taken in float64).
//
// One block per (query position t, KV head h, batch row b), all G query
// heads of that KV head:
//   1. dequantize, value = e^s * (code / n): q's G x dh and v's L x dh into
//      shared memory; k row by row in registers;
//   2. a thread per key j: score = sum_d q[d] * k[j, d], d = 0, 1, ... in
//      turn, / sqrt(dh); -1e30 where j > qpos[b, t];
//   3. thread g: the max over keys; then every thread e_j = exp(s_j - m);
//      thread g: the sum over j = 0, 1, ... in turn; every thread p_j =
//      e_j / sum;
//   4. a thread per output (g, d): ctx = sum_j p_j * v[j, d], j in turn.
//
// Bound: at the LM's decode shapes (B = 1-8 slots, L = 128 keys, 2 KV
// heads x 2 query heads x dh 16) a call moves ~2 x 4 KB of cache a row and
// does ~16 K float32 operations: far below a microsecond of bytes or
// operations, so its time is the launch and the serial chains of steps 3
// and 4 (L dependent adds each), which the fixed order asks for. The
// design keeps the whole row group in one block, with no second pass and
// no atomics.
#include "epilogue.cuh"

namespace {

constexpr int THREADS = 128;

// XLA's float32 exp constants (core/quant.py)
constexpr float EXP_LO = -88.3762626647949f, EXP_HI = 88.73f;
constexpr float LOG2E = 1.44269504088896341f;
constexpr float LN2_HI = 0.693359375f, LN2_LO = -2.12194440e-4f;
constexpr float FLT_MIN_F = 1.1754943508222875e-38f;

// float32 a * b + c with one rounding: the product of two float32 values is
// exact in float64, then the add rounds in float64, then to float32 (as
// core/quant.py::_fma32 computes it)
__device__ __forceinline__ float fma32(float a, float b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), c));
}

__device__ __forceinline__ float xla_exp(float s) {
  const float x = fminf(fmaxf(s, EXP_LO), EXP_HI);
  const float fx = fminf(floorf(fma32(x, LOG2E, 0.5)), 127.0f);
  float r = fma32(fx, -LN2_HI, (double)x);
  r = fma32(fx, -LN2_LO, (double)r);
  float y = 1.9875691500e-4f;
  y = fma32(y, r, (double)1.3981999507e-3f);
  y = fma32(y, r, (double)8.3334519073e-3f);
  y = fma32(y, r, (double)4.1665795894e-2f);
  y = fma32(y, r, (double)1.6666665459e-1f);
  y = fma32(y, r, (double)5.0000001201e-1f);
  y = __fadd_rn(fma32(y, __fmul_rn(r, r), (double)r), 1.0f);
  const float two_n = __int_as_float(((int)fx + 127) << 23);
  const float out = __fmul_rn(y, two_n);
  return out < FLT_MIN_F ? 0.0f : out;
}

__device__ __forceinline__ float deq(int8_t code, float e, float n) {
  return __fmul_rn(e, __fdiv_rn((float)code, n));
}

__global__ void __launch_bounds__(THREADS)
lm_island_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v,
                 const float* __restrict__ scales,
                 const int* __restrict__ qpos, float* __restrict__ out,
                 int Tq, int L, int KV, int G, int DH, float n,
                 float sqrt_dh) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* qs = smem;             // G x DH
  float* vs = qs + G * DH;      // L x DH
  float* sc = vs + L * DH;      // G x L: scores, then e, then p
  float* red = sc + G * L;      // G maxima, G sums
  const float eq = scales[0], ek = scales[1], ev = scales[2];
  const int H = KV * G;
  const long long qrow = ((long long)b * Tq + t) * H * DH;
  for (int i = threadIdx.x; i < G * DH; i += THREADS)
    qs[i] = deq(q[qrow + (long long)h * G * DH + i], eq, n);
  for (int i = threadIdx.x; i < L * DH; i += THREADS) {
    const int j = i / DH, d = i % DH;
    vs[i] = deq(v[(((long long)b * L + j) * KV + h) * DH + d], ev, n);
  }
  const int limit = qpos[b * Tq + t];
  __syncthreads();

  for (int j = threadIdx.x; j < L; j += THREADS) {
    const int8_t* kr = k + (((long long)b * L + j) * KV + h) * DH;
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * DH;
      float acc = __fmul_rn(qg[0], deq(kr[0], ek, n));
      for (int d = 1; d < DH; ++d)
        acc = __fadd_rn(acc, __fmul_rn(qg[d], deq(kr[d], ek, n)));
      const float s = __fdiv_rn(acc, sqrt_dh);
      sc[g * L + j] = j <= limit ? s : -1e30f;
    }
  }
  __syncthreads();

  if (threadIdx.x < G) {
    const float* row = sc + threadIdx.x * L;
    float m = row[0];
    for (int j = 1; j < L; ++j) m = fmaxf(m, row[j]);
    red[threadIdx.x] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * L; i += THREADS)
    sc[i] = xla_exp(__fsub_rn(sc[i], red[i / L]));
  __syncthreads();
  if (threadIdx.x < G) {
    const float* row = sc + threadIdx.x * L;
    float total = row[0];
    for (int j = 1; j < L; ++j) total = __fadd_rn(total, row[j]);
    red[G + threadIdx.x] = total;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * L; i += THREADS)
    sc[i] = __fdiv_rn(sc[i], red[G + i / L]);
  __syncthreads();

  for (int o = threadIdx.x; o < G * DH; o += THREADS) {
    const int g = o / DH, d = o % DH;
    const float* p = sc + g * L;
    float acc = __fmul_rn(p[0], vs[d]);
    for (int j = 1; j < L; ++j)
      acc = __fadd_rn(acc, __fmul_rn(p[j], vs[j * DH + d]));
    out[qrow + (long long)h * G * DH + o] = acc;
  }
}

}  // namespace

// q (B, Tq, KV * G * DH), k / v (B, L, KV, DH) int8; scales (3,) e^s of q,
// k, v; qpos (B, Tq) int32; out (B, Tq, KV * G * DH) float32.
extern "C" int fq_lm_island(const void* q, const void* k, const void* v,
                            const void* scales, const void* qpos, void* out,
                            int B, int Tq, int L, int KV, int G, int DH,
                            int n, float sqrt_dh, void* stream) {
  if (B > 0 && Tq > 0) {
    const size_t smem = sizeof(float) * (G * DH + L * DH + G * L + 2 * G);
    lm_island_kernel<<<dim3(Tq, KV, B), THREADS, smem,
                       (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)k, (const int8_t*)v,
        (const float*)scales, (const int*)qpos, (float*)out, Tq, L, KV, G,
        DH, (float)n, sqrt_dh);
  }
  return (int)cudaGetLastError();
}
