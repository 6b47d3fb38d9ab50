// The integer LM's attention island: masked GQA softmax attention over the
// int8 code-domain KV cache, and the context's re-entry into int8 codes.
//
// Replaces no TPU kernel: repro/models/fq_lm.py::_attention (fq_lm.py:
// 202-218) is plain jnp einsum / softmax in the reference, and its
// re-entry is wo's input quantizer. It is a kernel here because its outputs
// must not depend on the shape of the call (the reference's tests hold
// prefill(T) + decode == prefill(T + 1) and batched == unbatched decode bit
// for bit), and cuBLAS and PyTorch's reductions pick their summation order
// from the whole shape. This kernel fixes the order over the cache's slots
// (kernels/lm_island.py, module doc), and lm_island_plain repeats it in
// elementwise PyTorch ops; the two are bit-identical. Every float32 step is
// one IEEE operation rounded to nearest (__f*_rn, and the library builds
// with --fmad=false: no contraction), the exp is core/quant.py::exp (XLA's
// float32 exp: Cephes with each multiply-add fused, taken in float64).
//
// One warp per query head (b, t, h, g), the G query heads of KV head h in
// one block of G warps. Lane l owns slots j = 32 c + l, chunk c = 0, 1, ...
// up to the query's last needed key min(qpos, L - 1): it reads only the
// keys the query needs, and never a dequantized tile in shared memory.
//   1. the loads that depend on nothing (the scales, the query's position,
//      q's codes, e_in), then the lane's K and V rows of the first CACHED
//      chunks (4 at d_head 16: the LM's 128-key cache) into registers, all
//      in flight while the block fills a table of e^s * (code / n) for
//      every int8 code and each of the q, k and v scales (3 x 256 floats),
//      so no division is left in the loops;
//   2. each lane scores its slots (the sum over d in turn of q[d] k[j, d],
//      / sqrt(dh)). The CACHED chunks run unrolled and without branches, so
//      their chains overlap: a slot past the last needed one loads nothing
//      and is masked (it takes no part in the max, adds an exact +0.0 to
//      the sums: a partial starts at +0.0, so it is never -0.0). A later
//      chunk loads its rows and recomputes its score where needed, so the
//      cache's length has no ceiling;
//   3. m: a per-lane max, then a __shfl_xor_sync butterfly (exact);
//   4. e_j = exp(s_j - m): a per-lane partial from +0.0f over the chunks in
//      turn, then the xor butterfly over offsets 16, 8, 4, 2, 1 (every lane
//      ends with the same total: float addition commutes);
//   5. p_j = e_j / total; the context per d the same two steps over
//      p_j * v[j, d] (a butterfly a d);
//   6. code = rint(min(max(ctx / e_in, -1), 1) * n_a), int8, lane d % 32
//      storing d's.
// The CACHED chunks hold the LM's whole 128-key cache in registers after
// one load; one loop over all chunks, loading and scoring each slot in each
// of the three passes, takes up to 1.7 times as long at the LM's shapes
// (PERF.md).
// A K or V row is one 16-byte copy per 16 codes (the vector loader: d_head
// % 16 == 0 and 16-byte aligned operands) or byte loads.
//
// Bound: at the LM's decode shapes (B = 1-8 slots, L = 128, 2 KV heads x 2
// query heads x dh 16) a call needs a few KB of cache and ~10^4 float32
// operations: far below a microsecond of either, so its time is the launch
// and each warp's chain of dependent instructions (PERF.md). The design
// shortens that chain: one warp a query head over 32 slots at once, the
// cached chunks' chains side by side, five shuffle steps per reduction,
// and the re-entry quantizer in the same launch.
#include <cmath>

#include "epilogue.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The fixed tree: lane l adds lane l ^ off, off = 16, 8, 4, 2, 1.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// One q, K or V row's int8 codes in registers, 4 a word, each byte stored
// as code + 128 (the table's index; a xor with 0x80 a byte): one 16-byte
// load per 16 codes (VEC) or byte loads; 0 (code -128) until loaded. DHMAX
// bounds dh at compile time, so the arrays indexed by d stay registers.
template <int DHMAX, bool VEC>
struct RowCodes {
  static constexpr uint32_t BIAS = 0x80808080u;
  uint32_t w[DHMAX / 4];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < DHMAX / 4; ++i) w[i] = 0;
  }

  __device__ __forceinline__ void load(const int8_t* __restrict__ row,
                                       int dh) {
    if constexpr (VEC) {
#pragma unroll
      for (int c = 0; c < DHMAX / 16; ++c) {
        if (16 * c >= dh) break;
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + c);
        w[4 * c] = x.x ^ BIAS;
        w[4 * c + 1] = x.y ^ BIAS;
        w[4 * c + 2] = x.z ^ BIAS;
        w[4 * c + 3] = x.w ^ BIAS;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DHMAX / 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i + k < dh)
            word |= (uint32_t)(uint8_t)__ldg(row + 4 * i + k) << (8 * k);
        w[i] = word ^ BIAS;
      }
    }
  }

  // f(d, value) for d = 0 .. dh - 1 in turn, value the table's entry for
  // code d (tab[code + 128])
  template <class F>
  __device__ __forceinline__ void values(int dh, const float* tab,
                                         F&& f) const {
#pragma unroll
    for (int d = 0; d < DHMAX; ++d) {
      if (d >= dh) break;
      f(d, tab[(w[d / 4] >> (8 * (d % 4))) & 0xffu]);
    }
  }
};

template <int DHMAX, bool VEC>
__global__ void lm_island_kernel(const int8_t* __restrict__ q,
                                 const int8_t* __restrict__ k,
                                 const int8_t* __restrict__ v,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ qpos,
                                 const float* __restrict__ e_in,
                                 int8_t* __restrict__ out, int Tq, int L,
                                 int KV, int G, int DH, float n, float n_a,
                                 float sqrt_dh) {
  // the chunks whose rows are loaded ahead and whose scores stay in
  // registers
  constexpr int CACHED = DHMAX >= 64 ? 1 : 64 / DHMAX;
  using Row = RowCodes<DHMAX, VEC>;
  __shared__ float tab[3][256];  // e^s * (code / n) at code + 128
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const long long orow =
      ((long long)b * Tq + t) * KV * G * DH + (long long)(h * G + g) * DH;
  auto row = [&](const int8_t* base, int j) {
    return base + (((long long)b * L + j) * KV + h) * DH;
  };

  // 1. the loads that depend on nothing, then the rows of the cached
  // chunks, in flight while the block fills the table
  const float sq = scales[0], sk = scales[1], sv = scales[2];
  const float ein = *e_in;
  Row qr;
  qr.load(q + orow, DH);
  const int last = min(qpos[b * Tq + t], L - 1);  // the last needed slot
  const int nc = last < 0 ? 0 : last / LANES + 1;
  Row kr[CACHED], vr[CACHED];
  bool live[CACHED];
#pragma unroll
  for (int c = 0; c < CACHED; ++c) {
    const int j = LANES * c + lane;
    live[c] = j <= last;
    kr[c].clear();
    vr[c].clear();
    if (live[c]) {
      kr[c].load(row(k, j), DH);
      vr[c].load(row(v, j), DH);
    }
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const float x = __fdiv_rn((float)(i - 128), n);
    tab[0][i] = __fmul_rn(sq, x);
    tab[1][i] = __fmul_rn(sk, x);
    tab[2][i] = __fmul_rn(sv, x);
  }
  __syncthreads();

  float qf[DHMAX];
  qr.values(DH, tab[0], [&](int d, float x) { qf[d] = x; });
  auto dot = [&](const Row& kj) {
    float acc = 0.0f;
    kj.values(DH, tab[1], [&](int d, float x) {
      const float p = __fmul_rn(qf[d], x);
      acc = d == 0 ? p : __fadd_rn(acc, p);
    });
    return __fdiv_rn(acc, sqrt_dh);
  };
  auto score = [&](int j) {  // a slot past the cached chunks
    Row kj;
    kj.load(row(k, j), DH);
    return dot(kj);
  };

  // 2-3: scores and their max
  float s[CACHED];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < CACHED; ++c) {
    s[c] = dot(kr[c]);
    m = fmaxf(m, live[c] ? s[c] : -INFINITY);
  }
  for (int c = CACHED; c < nc; ++c) {
    const int j = LANES * c + lane;
    if (j <= last) m = fmaxf(m, score(j));
  }
  m = warp_max(m);

  // 4: e_j and the sum
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < CACHED; ++c) {
    const float e = xla_exp(__fsub_rn(s[c], m));
    s[c] = live[c] ? e : 0.0f;
    part = __fadd_rn(part, s[c]);
  }
  for (int c = CACHED; c < nc; ++c) {
    const int j = LANES * c + lane;
    if (j <= last) part = __fadd_rn(part, xla_exp(__fsub_rn(score(j), m)));
  }
  const float total = warp_sum(part);

  // 5: the context
  float ctx[DHMAX];
#pragma unroll
  for (int d = 0; d < DHMAX; ++d) ctx[d] = 0.0f;
  auto add_row = [&](const Row& vj, float p) {
    vj.values(DH, tab[2], [&](int d, float x) {
      ctx[d] = __fadd_rn(ctx[d], __fmul_rn(p, x));
    });
  };
#pragma unroll
  for (int c = 0; c < CACHED; ++c)
    add_row(vr[c], live[c] ? __fdiv_rn(s[c], total) : 0.0f);
  for (int c = CACHED; c < nc; ++c) {
    const int j = LANES * c + lane;
    if (j <= last) {
      Row vj;
      vj.load(row(v, j), DH);
      add_row(vj, __fdiv_rn(xla_exp(__fsub_rn(score(j), m)), total));
    }
  }

  // 6: the tree over lanes a d, then the re-entry codes, lane d % 32
  // storing d's
#pragma unroll
  for (int d = 0; d < DHMAX; ++d) {
    if (d >= DH) break;
    const float x = warp_sum(ctx[d]);
    if (lane == d % LANES) {
      const float y = fminf(fmaxf(__fdiv_rn(x, ein), -1.0f), 1.0f);
      out[orow + d] = (int8_t)__float2int_rn(rintf(__fmul_rn(y, n_a)));
    }
  }
}

template <int DHMAX>
void launch(bool vec, dim3 grid, int threads, cudaStream_t st,
            const int8_t* q, const int8_t* k, const int8_t* v,
            const float* scales, const int* qpos, const float* e_in,
            int8_t* out, int Tq, int L, int KV, int G, int DH, float n,
            float n_a, float sqrt_dh) {
  if (vec)
    lm_island_kernel<DHMAX, true><<<grid, threads, 0, st>>>(
        q, k, v, scales, qpos, e_in, out, Tq, L, KV, G, DH, n, n_a, sqrt_dh);
  else
    lm_island_kernel<DHMAX, false><<<grid, threads, 0, st>>>(
        q, k, v, scales, qpos, e_in, out, Tq, L, KV, G, DH, n, n_a, sqrt_dh);
}

}  // namespace

// q (B, Tq, KV * G * DH), k / v (B, L, KV, DH) int8; scales (3,) e^s of q,
// k, v; qpos (B, Tq) int32; e_in (1,) e^s of the re-entry quantizer; out
// (B, Tq, KV * G * DH) int8 codes at n_a levels. vec: the 16-byte loader
// (DH % 16 == 0, q, k and v 16-byte aligned). G <= 32, DH <= 128.
extern "C" int fq_lm_island(const void* q, const void* k, const void* v,
                            const void* scales, const void* qpos,
                            const void* e_in, void* out, int B, int Tq,
                            int L, int KV, int G, int DH, int n, int n_a,
                            int vec, float sqrt_dh, void* stream) {
  if (G < 1 || G > LANES || DH < 1 || DH > 128 ||
      (vec && (DH % 16 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
               (uintptr_t)v % 16)))
    return (int)cudaErrorInvalidValue;
  if (B > 0 && Tq > 0 && KV > 0) {
    const dim3 grid(Tq, KV, B);
    const auto args = [&](auto launcher) {
      launcher(vec != 0, grid, LANES * G, (cudaStream_t)stream,
               (const int8_t*)q, (const int8_t*)k, (const int8_t*)v,
               (const float*)scales, (const int*)qpos, (const float*)e_in,
               (int8_t*)out, Tq, L, KV, G, DH, (float)n, (float)n_a,
               sqrt_dh);
    };
    if (DH <= 16) args(launch<16>);
    else if (DH <= 32) args(launch<32>);
    else if (DH <= 64) args(launch<64>);
    else args(launch<128>);
  }
  return (int)cudaGetLastError();
}
