// K1: learned quantization to int8 codes (paper eq. 1 + 2).
//
// Replaces repro/kernels/quantize.py::quantize_codes (Pallas _kernel, row
// tiles of 256 through VMEM). Elementwise:
//   codes = rint(clip(x * inv_scale, b, 1) * n) -> int8
// in exactly that order (__fmul_rn, clip, __fmul_rn, __float2int_rn: round
// half to even), so the codes are the plain version's bit for bit.
//
// Bound: bytes. 5 a element (4 read, 1 written) against one multiply,
// clip, multiply and round: far below the card's operations-per-byte line.
// At the paper's deployments the whole pass is small: KWS at B = 64 is
// 896,000 elements (4.48 MB, 1.34 us at 3.35 TB/s), DarkNet-19's entry at
// B = 8 is 3,211,264 (16.1 MB, 4.79 us). An empty kernel replayed from a
// CUDA graph (fq_launch_floor below, timed by chip_smoke.py) is a floor of
// the same order as KWS's bytes, so there a launch, not the bytes, is
// most of the time.
//
// Design, for the bytes:
//   * vector transfers: each thread turns 8 elements, two 16-byte float4
//     loads, into 8 codes and writes them as one 8-byte store, so a warp
//     moves 1 KB in and 256 B out per step in full 32-byte sectors (16
//     elements a thread, one 16-byte store, measured slower on the card
//     at every model size: half the threads, twice the serial work each);
//   * the grid is at most BLOCKS_PER_SM blocks of 256 threads per SM (the
//     wrapper reads the SM count once per device), one step a thread at
//     the paper's sizes, all of it in flight at once;
//   * inv_scale is read once per block from device memory into shared
//     memory, while the threads' first loads are in flight: no host sync,
//     and the launch is capturable in a CUDA graph;
//   * edges in the same kernel: the body starts at x's first 16-byte
//     boundary and covers whole steps of 8; the `head` elements before it
//     (a view such as x[1:] or an odd row offset) and the tail of fewer
//     than 8 after it go to one more block of the same launch, launched
//     only when there are any, so the body's threads carry no edge code in
//     their path (per-thread head and tail checks measured slower on the
//     card at every model size). When the body's codes do not start on an 8-byte boundary of
//     `out` (x and out misaligned differently) the body stores them byte
//     by byte, a branch taken once per thread before its loop.
// The reference's row tile (block_rows) has no counterpart: it sized VMEM
// blocks; here a thread's 8 elements are the tile.
#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256, F4 = 2, VEC = 4 * F4;

__device__ __forceinline__ int8_t code(float v, float inv, float b,
                                       float levels) {
  float u = __fmul_rn(v, inv);
  u = fminf(fmaxf(u, b), 1.0f);
  return (int8_t)__float2int_rn(__fmul_rn(u, levels));
}

__device__ __forceinline__ uint32_t pack4(const float4& v, float inv,
                                          float b, float levels) {
  return (uint32_t)(uint8_t)code(v.x, inv, b, levels) |
         (uint32_t)(uint8_t)code(v.y, inv, b, levels) << 8 |
         (uint32_t)(uint8_t)code(v.z, inv, b, levels) << 16 |
         (uint32_t)(uint8_t)code(v.w, inv, b, levels) << 24;
}

// inv_scale from device memory, once per block, through shared memory.
__device__ __forceinline__ float block_inv(const float* inv_scale) {
  __shared__ float inv_s;
  if (threadIdx.x == 0) inv_s = *inv_scale;
  __syncthreads();
  return inv_s;
}

// The body: step v is the 8 elements xv[F4 v ..], codes ob[VEC v ..].
template <bool STORE8>
__device__ __forceinline__ void body(const float4* __restrict__ xv,
                                     int8_t* __restrict__ ob, long long steps,
                                     int body_blocks, const float* inv_scale,
                                     float b, float levels) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)body_blocks * THREADS;
  float4 f[F4];
  // the first step's loads go out before the barrier of block_inv
  if (tid < steps) {
#pragma unroll
    for (int j = 0; j < F4; ++j) f[j] = __ldg(xv + F4 * tid + j);
  }
  const float inv = block_inv(inv_scale);
  for (long long v = tid; v < steps; v += stride) {
    if (v != tid) {
#pragma unroll
      for (int j = 0; j < F4; ++j) f[j] = __ldg(xv + F4 * v + j);
    }
    const uint2 c = make_uint2(pack4(f[0], inv, b, levels),
                               pack4(f[1], inv, b, levels));
    if constexpr (STORE8) {
      *reinterpret_cast<uint2*>(ob + VEC * v) = c;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        ob[VEC * v + j] = (int8_t)((j < 4 ? c.x : c.y) >> (8 * (j % 4)));
    }
  }
}

// Blocks 0 .. body_blocks - 1 run the body (x + head 16-byte aligned;
// store8: out + head 8-byte aligned); block body_blocks, launched when
// head or tail is not empty, the head x[0, head) and the tail
// x[head + VEC steps, n).
__global__ void __launch_bounds__(THREADS)
quantize_codes_kernel(const float* __restrict__ x,
                      const float* __restrict__ inv_scale,
                      int8_t* __restrict__ out, long long n, int head,
                      long long steps, int body_blocks, bool store8, float b,
                      float levels) {
  if ((int)blockIdx.x == body_blocks) {
    const float inv = block_inv(inv_scale);
    const long long t0 = head + VEC * steps;
    for (long long i = threadIdx.x; i < head + (n - t0); i += THREADS) {
      const long long e = i < head ? i : t0 + (i - head);
      out[e] = code(x[e], inv, b, levels);
    }
    return;
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  if (store8)
    body<true>(xv, out + head, steps, body_blocks, inv_scale, b, levels);
  else
    body<false>(xv, out + head, steps, body_blocks, inv_scale, b, levels);
}

__global__ void fq_launch_floor_kernel() {}

}  // namespace

// max_blocks: the body's grid cap, BLOCKS_PER_SM x the SM count (the
// wrapper's); one more block when there are edges.
extern "C" int fq_quantize_codes(const void* x, const void* inv_scale,
                                 void* out, long long n, float b, int levels,
                                 int max_blocks, void* stream) {
  if (n > 0) {
    const uintptr_t xa = (uintptr_t)x;
    if (xa % 4) return (int)cudaErrorMisalignedAddress;
    long long head = (long long)((16 - xa % 16) % 16) / 4;
    if (head > n) head = n;
    const long long steps = (n - head) / VEC;
    const bool edges = head > 0 || head + VEC * steps < n;
    const bool store8 = ((uintptr_t)out + head) % 8 == 0;
    long long blocks = (steps + THREADS - 1) / THREADS;
    if (blocks > max_blocks) blocks = max_blocks;
    quantize_codes_kernel<<<(unsigned)(blocks + edges), THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const float*)x, (const float*)inv_scale, (int8_t*)out, n, (int)head,
        steps, (int)blocks, store8, b, (float)levels);
  }
  return (int)cudaGetLastError();
}

// An empty kernel of `blocks` x `threads`: the launch floor that K1's times
// are read against (chip_smoke.py times it as a CUDA-graph replay).
extern "C" int fq_launch_floor(int blocks, int threads, void* stream) {
  fq_launch_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
