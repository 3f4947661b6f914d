// dyncore: value-only FK + foot velocities + RNEA for M independent
// evaluations, out (M, 42) = [p_feet 12 | v_feet 12 | tau 18].
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:dyncore_pallas
// (_dyncore_kernel). On the RTI path M = n_alpha * B * (N+1): 2 * 512 * 26 =
// 26,624 on the main path's chain, 2 * 256 * 101 at N=100, 2 * 256 * 26 in
// datagen, 52 (104 with four alphas) in the closed loop's B=1 replan.
//
// Bound on this card: neither bytes nor operations. At M = 26,624 the
// bytes (66 floats in, 42 out a row: 11.5 MB) take 3.4 us at 3.35 TB/s and
// the operations (~6.6 k flops a row by hand, ~10.9 k as the plain twin
// counts them) 2.6-4.3 us at 67 TFLOP/s. What limits it is issue and
// latency: each evaluation is a long dependent scalar chain through 15
// sin/cos pairs and 12 links, and the card needs enough such chains in
// flight to fill its issue slots. A thread per evaluation (the first port) gave ~6 warps
// an SM at M = 26,624 and one warp at M = 52, read its rows at strides of
// 144, 72 and 48 B, and kept its per-leg arrays in local memory (a rolled
// leg loop indexing them by the leg): 0.031 ms alone at M = 26,624 on an
// H100 SXM (700 W).
//
// Design: a leg per lane. Four consecutive lanes take one evaluation, so a
// warp holds 8 and a block of DC_THREADS = 256 threads DC_EVALS = 64. Lane
// l computes the trunk's frame, rates and accelerations itself (3 sin/cos
// pairs, ~100 flops, no barrier), runs leg l's three-link chain with its
// joint values in registers and every per-thread index static (leg_chain;
// 126 registers, no local memory, 2 blocks = 16 warps an SM), and gives
// foot l's point and velocity and joint torques 6+3l..8+3l. The legs'
// wrenches on the trunk are summed over the four lanes by two
// __shfl_xor_sync steps, (l0 + l1) + (l2 + l3) in every lane, bit for bit
// the same each run; the trunk's Newton-Euler and tau 0..5 follow in every
// lane, and lane 0 stores them. A block's rows of X, A, F are one
// contiguous span each: the block copies them into shared memory with
// neighbouring threads on neighbouring addresses (16-byte accesses when the
// span's start is 16-byte aligned, 4-byte ones otherwise: a view may start
// at any float), and its 64 x 42 output tile back out the same way. The
// robot constants (N_CONSTS floats) are staged once a block. Accurate
// sinf/cosf and fp32 FMAs only; against the plain twin the four-leg sums'
// order is the new difference. trunk_state, leg_chain and trunk_wrench live
// in legdyn.cuh, templated on the scalar: dynjac runs them on Dual.
// body_pass stays as the other Dual callers (lingram, the terminal Gram)
// have it: their register budgets and the split chain's bit-equality rest
// on it.
#include <stdint.h>

#include "legdyn.cuh"

// 256 threads a block, 64 evaluations; 2 blocks an SM fit without a
// register cap (126 registers); a tighter cap spills (PERF.md)
#define DC_THREADS 256
#define DC_EVALS (DC_THREADS / 4)
#define DC_OUT 42

// n floats from src (device memory) to dst (shared, 16-byte aligned), the
// block's threads on neighbouring addresses.
__device__ __forceinline__ void stage_in(float* dst, const float* __restrict__ src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n & ~3;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < done / 4; i += DC_THREADS) d4[i] = __ldg(s4 + i);
  }
  for (int i = done + threadIdx.x; i < n; i += DC_THREADS) dst[i] = __ldg(src + i);
}

// n floats from src (shared, 16-byte aligned) to dst (device memory).
__device__ __forceinline__ void stage_out(float* __restrict__ dst, const float* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = n & ~3;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < done / 4; i += DC_THREADS) d4[i] = s4[i];
  }
  for (int i = done + threadIdx.x; i < n; i += DC_THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(DC_THREADS, 2)
dyncore_kernel(const float* __restrict__ X, const float* __restrict__ A,
               const float* __restrict__ F, const float* __restrict__ consts,
               float* __restrict__ out, int M) {
  __shared__ float Cs[N_CONSTS];
  __shared__ __align__(16) float Xs[DC_EVALS * 36];
  __shared__ __align__(16) float As[DC_EVALS * 18];
  __shared__ __align__(16) float Es[DC_EVALS * 12];
  __shared__ __align__(16) float Os[DC_EVALS * DC_OUT];
  const size_t m0 = (size_t)blockIdx.x * DC_EVALS;
  const int n = min(DC_EVALS, M - (int)m0);
  for (int i = threadIdx.x; i < N_CONSTS; i += DC_THREADS) Cs[i] = consts[i];
  stage_in(Xs, X + m0 * 36, n * 36);
  stage_in(As, A + m0 * 18, n * 18);
  stage_in(Es, F + m0 * 12, n * 12);
  __syncthreads();

  const int leg = threadIdx.x & 3;
  // lanes past the last evaluation repeat it (every lane takes part in the
  // shuffles) and store nothing
  const int e = min((int)(threadIdx.x >> 2), n - 1);
  const float* x = Xs + e * 36;
  const float* a = As + e * 18;
  Trunk<float> b;
  trunk_state(x, x + 18, a, b);
  float q3[3], v3[3], a3[3], fe3[3];
  for (int k = 0; k < 3; ++k) {
    q3[k] = x[6 + 3 * leg + k];
    v3[k] = x[24 + 3 * leg + k];
    a3[k] = a[6 + 3 * leg + k];
    fe3[k] = Es[e * 12 + 3 * leg + k];
  }
  float p_foot[3], v_foot[3], tau3[3], Fl[3], Ml[3], tau6[6];
  leg_chain(Cs, leg, b, q3, v3, a3, fe3, p_foot, v_foot, tau3, Fl, Ml);
  for (int s = 1; s <= 2; s <<= 1)
    for (int i = 0; i < 3; ++i) {
      Fl[i] = Fl[i] + __shfl_xor_sync(0xffffffffu, Fl[i], s);
      Ml[i] = Ml[i] + __shfl_xor_sync(0xffffffffu, Ml[i], s);
    }
  trunk_wrench(Cs, b, Fl, Ml, tau6);

  if ((int)(threadIdx.x >> 2) < n) {
    float* o = Os + e * DC_OUT;
    for (int i = 0; i < 3; ++i) {
      o[3 * leg + i] = p_foot[i];
      o[12 + 3 * leg + i] = v_foot[i];
      o[30 + 3 * leg + i] = tau3[i];
    }
    if (leg == 0)
      for (int i = 0; i < 6; ++i) o[24 + i] = tau6[i];
  }
  __syncthreads();
  stage_out(out + m0 * DC_OUT, Os, n * DC_OUT);
}

extern "C" int dyncore_launch(const float* X, const float* A, const float* F,
                              const float* consts, float* out, int M, void* stream) {
  const int blocks = (M + DC_EVALS - 1) / DC_EVALS;
  dyncore_kernel<<<blocks, DC_THREADS, 0, (cudaStream_t)stream>>>(X, A, F, consts, out, M);
  return (int)cudaGetLastError();
}

// The compiled kernel's registers a thread, local bytes a thread (stack
// frame and spills) and resident blocks an SM: out[0..2].
extern "C" int dyncore_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dyncore_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)dyncore_kernel,
                                                      DC_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
