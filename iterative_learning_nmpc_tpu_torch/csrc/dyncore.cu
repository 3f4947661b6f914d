// dyncore: value-only FK + foot velocities + RNEA for M independent
// evaluations, out (M, 42) = [p_feet 12 | v_feet 12 | tau 18].
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:dyncore_pallas
// (_dyncore_kernel). On the RTI path M = n_alpha * B * (N+1) = 2 * 512 * 26.
//
// Bound on this card: arithmetic latency of one long dependent scalar chain
// per thread (~3k flops, 66 floats in, 42 out; the bytes are small). Design:
// one thread per evaluation, fp32 scalars in registers, the robot constants
// staged once per block in shared memory; enough evaluations (26k) to keep
// every SM busy with independent chains.
#include "legdyn.cuh"

__global__ void __launch_bounds__(128)
dyncore_kernel(const float* __restrict__ X, const float* __restrict__ A,
               const float* __restrict__ F, const float* __restrict__ consts,
               float* __restrict__ out, int M) {
  __shared__ float Cs[N_CONSTS];
  for (int i = threadIdx.x; i < N_CONSTS; i += blockDim.x) Cs[i] = consts[i];
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float q[18], v[18], a[18], fe[12];
  const float* x = X + (size_t)m * 36;
  for (int i = 0; i < 18; ++i) {
    q[i] = x[i];
    v[i] = x[18 + i];
    a[i] = A[(size_t)m * 18 + i];
  }
  for (int i = 0; i < 12; ++i) fe[i] = F[(size_t)m * 12 + i];
  float pf[12], vf[12], tau[18];
  body_pass<float>(Cs, q, v, a, fe, pf, vf, tau);
  float* o = out + (size_t)m * 42;
  for (int i = 0; i < 12; ++i) {
    o[i] = pf[i];
    o[12 + i] = vf[i];
  }
  for (int i = 0; i < 18; ++i) o[24 + i] = tau[i];
}

extern "C" int dyncore_launch(const float* X, const float* A, const float* F,
                              const float* consts, float* out, int M, void* stream) {
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  dyncore_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(X, A, F, consts, out, M);
  return (int)cudaGetLastError();
}
