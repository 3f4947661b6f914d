// The structured Riccati solve of the batched GN step, as four kernels over
// the stages of riccati.cuh (terminal Gram, backward node, rollout):
//
//   riccati_rollout        terminal Gram + sweep + alpha = 1 rollout
//                          -> dX (B, N+1, 36), dU (B, N, 30);
//   riccati_sweep_terminal terminal Gram + sweep -> gains (B, N, 30, 37);
//   riccati_sweep          sweep from a given P_N (B, 36, 36), p_N (B, 36)
//                          -> gains (B, N, 30, 37);
//   forward_rollout        alpha = 1 rollout over gains -> dX, dU.
//
// The gains are [K | kff] per (problem, node), the port's counterpart of
// the TPU kernels' lane-major K/kff pair. They replace, in
// iterative_learning_nmpc_tpu/ops/riccati_kernel.py:
//   riccati_rollout        riccati_rollout_lane_major (_riccati_kernel with
//                          rollout=True, terminal Gram from _terminal_gram_init),
//   riccati_sweep_terminal riccati_pallas_lane_major(terminal=..., raw_out=True)
//                          (_riccati_kernel with rollout=False),
//   riccati_sweep          riccati_pallas_batched (_riccati_kernel with
//                          rollout=False and no terminal, P_N given),
//   forward_rollout        forward_rollout_lane_major (_forward_kernel).
//
// Bound on this card: the sequential dependence over nodes and, inside a
// node, over the 30 Cholesky pivots (latency, not bytes or flops: ~0.1
// MFLOP per node). Design: one 128-thread block per problem for the
// sweeps, P (36x36) and the node's Q-function blocks in shared memory, the
// 30x30 Cholesky right-looking with a pivot floor rsqrt(max(d, 1e-30)) as
// in the TPU kernel, the triangular solves one thread per right-hand-side
// column, and the K-free value update P <- Qxx - W^T W with
// W = L^{-1} [Qux | qu]. The fused kernel writes the gains to a scratch
// tensor and rolls out over them after a __syncthreads; the rollout kernel
// runs the same stage with one warp per problem (36 lanes of state need no
// more), four problems to a block.
#include "riccati.cuh"

__global__ void __launch_bounds__(128)
riccati_rollout_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                       const float* __restrict__ Mg, const float* __restrict__ qxg,
                       const float* __restrict__ rug, const float* __restrict__ dg,
                       const float* __restrict__ dx0g, const float* __restrict__ xNg,
                       const float* __restrict__ xrefg, const float* __restrict__ peakg,
                       const float* __restrict__ shg, const float* __restrict__ consts,
                       const float* __restrict__ tw, float* __restrict__ gains,
                       float* __restrict__ dXg, float* __restrict__ dUg, int N, float h,
                       float lm, float reg) {
  __shared__ float Cs[N_CONSTS];
  __shared__ RicSmem s;
  __shared__ float Jz[4][18];
  __shared__ float pz[4];
  __shared__ float dx[NX];
  __shared__ float dxn[NX];
  __shared__ float du[NU];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < N_CONSTS; i += nt) Cs[i] = consts[i];
  __syncthreads();
  ric_terminal_gram(Cs, xNg + (size_t)b * NX, xrefg + (size_t)b * NX, peakg + b * 4, shg[b],
                    tw, reg, Jz, pz, s, tid, nt);
  for (int n = N - 1; n >= 0; --n) {
    const size_t bn = (size_t)b * N + n;
    ric_node(Qg + bn * NX * NX, Rg + bn * NU * NU, Mg + bn * NX * NU, qxg + bn * NX,
             rug + bn * NU, dg + bn * NX, gains + bn * NU * NW, h, lm, s, tid, nt);
  }
  ric_rollout(gains + (size_t)b * N * NU * NW, dg + (size_t)b * N * NX, dx0g + (size_t)b * NX,
              dXg + (size_t)b * (N + 1) * NX, dUg + (size_t)b * N * NU, dx, dxn, du, N, h, tid,
              nt, BlockSync());
}

__global__ void __launch_bounds__(128)
riccati_sweep_terminal_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                              const float* __restrict__ Mg, const float* __restrict__ qxg,
                              const float* __restrict__ rug, const float* __restrict__ dg,
                              const float* __restrict__ xNg, const float* __restrict__ xrefg,
                              const float* __restrict__ peakg, const float* __restrict__ shg,
                              const float* __restrict__ consts, const float* __restrict__ tw,
                              float* __restrict__ gains, int N, float h, float lm, float reg) {
  __shared__ float Cs[N_CONSTS];
  __shared__ RicSmem s;
  __shared__ float Jz[4][18];
  __shared__ float pz[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < N_CONSTS; i += nt) Cs[i] = consts[i];
  __syncthreads();
  ric_terminal_gram(Cs, xNg + (size_t)b * NX, xrefg + (size_t)b * NX, peakg + b * 4, shg[b],
                    tw, reg, Jz, pz, s, tid, nt);
  for (int n = N - 1; n >= 0; --n) {
    const size_t bn = (size_t)b * N + n;
    ric_node(Qg + bn * NX * NX, Rg + bn * NU * NU, Mg + bn * NX * NU, qxg + bn * NX,
             rug + bn * NU, dg + bn * NX, gains + bn * NU * NW, h, lm, s, tid, nt);
  }
}

__global__ void __launch_bounds__(128)
riccati_sweep_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                     const float* __restrict__ Mg, const float* __restrict__ qxg,
                     const float* __restrict__ rug, const float* __restrict__ PNg,
                     const float* __restrict__ pNg, const float* __restrict__ dg,
                     float* __restrict__ gains, int N, float h, float lm) {
  __shared__ RicSmem s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = tid; e < NX * NX; e += nt) s.P[e / NX][e % NX] = PNg[(size_t)b * NX * NX + e];
  for (int i = tid; i < NX; i += nt) s.pv[i] = pNg[(size_t)b * NX + i];
  __syncthreads();
  for (int n = N - 1; n >= 0; --n) {
    const size_t bn = (size_t)b * N + n;
    ric_node(Qg + bn * NX * NX, Rg + bn * NU * NU, Mg + bn * NX * NU, qxg + bn * NX,
             rug + bn * NU, dg + bn * NX, gains + bn * NU * NW, h, lm, s, tid, nt);
  }
}

#define ROLL_WARPS 4

__global__ void __launch_bounds__(32 * ROLL_WARPS)
forward_rollout_kernel(const float* __restrict__ gains, const float* __restrict__ dg,
                       const float* __restrict__ dx0g, float* __restrict__ dXg,
                       float* __restrict__ dUg, int B, int N, float h) {
  __shared__ float dx[ROLL_WARPS][NX];
  __shared__ float dxn[ROLL_WARPS][NX];
  __shared__ float du[ROLL_WARPS][NU];

  const int w = threadIdx.x / 32;
  const int b = blockIdx.x * ROLL_WARPS + w;
  if (b >= B) return;     // whole warps only: the stage synchronizes per warp
  ric_rollout(gains + (size_t)b * N * NU * NW, dg + (size_t)b * N * NX, dx0g + (size_t)b * NX,
              dXg + (size_t)b * (N + 1) * NX, dUg + (size_t)b * N * NU, dx[w], dxn[w], du[w],
              N, h, threadIdx.x % 32, 32, WarpSync());
}

extern "C" int riccati_rollout_launch(const float* Q, const float* R, const float* M,
                                      const float* qx, const float* ru, const float* d,
                                      const float* dx0, const float* xN, const float* xref,
                                      const float* peak, const float* sh, const float* consts,
                                      const float* tw, float* gains, float* dX, float* dU,
                                      int B, int N, float h, float lm, float reg,
                                      void* stream) {
  riccati_rollout_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      Q, R, M, qx, ru, d, dx0, xN, xref, peak, sh, consts, tw, gains, dX, dU, N, h, lm, reg);
  return (int)cudaGetLastError();
}

extern "C" int riccati_sweep_terminal_launch(const float* Q, const float* R, const float* M,
                                             const float* qx, const float* ru, const float* d,
                                             const float* xN, const float* xref,
                                             const float* peak, const float* sh,
                                             const float* consts, const float* tw,
                                             float* gains, int B, int N, float h, float lm,
                                             float reg, void* stream) {
  riccati_sweep_terminal_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      Q, R, M, qx, ru, d, xN, xref, peak, sh, consts, tw, gains, N, h, lm, reg);
  return (int)cudaGetLastError();
}

extern "C" int riccati_sweep_launch(const float* Q, const float* R, const float* M,
                                    const float* qx, const float* ru, const float* PN,
                                    const float* pN, const float* d, float* gains, int B, int N,
                                    float h, float lm, void* stream) {
  riccati_sweep_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      Q, R, M, qx, ru, PN, pN, d, gains, N, h, lm);
  return (int)cudaGetLastError();
}

extern "C" int forward_rollout_launch(const float* gains, const float* d, const float* dx0,
                                      float* dX, float* dU, int B, int N, float h,
                                      void* stream) {
  const int blocks = (B + ROLL_WARPS - 1) / ROLL_WARPS;
  forward_rollout_kernel<<<blocks, 32 * ROLL_WARPS, 0, (cudaStream_t)stream>>>(
      gains, d, dx0, dX, dU, B, N, h);
  return (int)cudaGetLastError();
}
