// The structured Riccati solve of the batched GN step, as four kernels over
// the stages of riccati.cuh (terminal Gram, backward sweep, rollout):
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
// node, over the 30 Cholesky pivots and the two triangular solves (latency,
// not bytes or flops: ~0.1 MFLOP per node). Design: one block of
// RIC_THREADS threads per problem for the sweeps, running riccati.cuh's
// node stage (a factor warp with Quu in registers, column threads for the
// solves, tile threads for Qxx and the value update, the next node's
// blocks prefetched by cp.async into a double buffer; 49,280 bytes of
// dynamic shared memory, four blocks an SM). The fused kernel writes the
// gains to a scratch tensor and rolls out over them after the sweep's last
// __syncthreads, by its first warp, the rollout's ring laid over the
// sweep's shared memory; the rollout kernel runs the same stage, one warp
// (one problem) a block, so B=256 fills the card's 132 SMs. Bound of the
// rollout: bytes (riccati.cuh, ric_rollout).
#include <stdint.h>

#include "riccati.cuh"

extern __shared__ __align__(16) unsigned char ric_smem[];

__device__ __forceinline__ RicProblem ric_problem(const float* Q, const float* R, const float* M,
                                                  const float* qx, const float* ru,
                                                  const float* d, float* gains, int b, int N) {
  const size_t bn = (size_t)b * N;
  return RicProblem{Q + bn * NX * NX, R + bn * NU * NU, M + bn * NX * NU, qx + bn * NX,
                    ru + bn * NU,     d + bn * NX,      gains + bn * NU * NW};
}

// Kernel 3's rollout as a call, not inlined: inlined, its code changed the
// register allocation and scheduling of the sweep before it, whose nodes
// then ran 5-17 % slower than kernel 4's (traced: 15,211 against 12,946
// cycles a node at B=256, N=100; scripts/time_riccati_torch.py --trace).
__device__ __noinline__ void ric_rollout_call(const float* G, const float* d, const float* gend,
                                             const float* dx0, float* dX, float* dU,
                                             RollSmem& s, int N, float h, int lane) {
  ric_rollout(G, d, gend, dx0, dX, dU, s, N, h, lane);
}

__global__ void __launch_bounds__(RIC_THREADS, 4)
riccati_rollout_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                       const float* __restrict__ Mg, const float* __restrict__ qxg,
                       const float* __restrict__ rug, const float* __restrict__ dg,
                       const float* __restrict__ dx0g, const float* __restrict__ xNg,
                       const float* __restrict__ xrefg, const float* __restrict__ peakg,
                       const float* __restrict__ shg, const float* __restrict__ consts,
                       const float* __restrict__ tw, float* __restrict__ gains,
                       float* __restrict__ dXg, float* __restrict__ dUg, int N, float h,
                       float lm, float reg) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(ric_smem);
  __shared__ float Cs[N_CONSTS];
  __shared__ float Jz[4][18];
  __shared__ float pz[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  RIC_SPAN(0);
  const RicProblem g = ric_problem(Qg, Rg, Mg, qxg, rug, dg, gains, b, N);
  if (N > 0) ric_prefetch(g, N - 1, s, tid);
  for (int i = tid; i < N_CONSTS; i += RIC_THREADS) Cs[i] = consts[i];
  __syncthreads();
  ric_terminal_gram(Cs, xNg + (size_t)b * NX, xrefg + (size_t)b * NX, peakg + b * 4, shg[b],
                    tw, reg, Jz, pz, s, tid, RIC_THREADS);
  ric_sweep(g, N, h, lm, s, tid);
  // the rollout, by warp 0, over the gains this block just wrote (plain
  // stores, read back by bulk copies: the proxy fence before the barrier
  // orders them), its ring over the sweep's shared memory, free after the
  // sweep's last __syncthreads
  ric_fence_proxy_async();
  __syncthreads();
  if (tid < 32) {
    ric_rollout_call(g.G, g.d, gains + (size_t)gridDim.x * N * NU * NW, dx0g + (size_t)b * NX,
                     dXg + (size_t)b * (N + 1) * NX, dUg + (size_t)b * N * NU,
                     *reinterpret_cast<RollSmem*>(ric_smem), N, h, tid);
    RIC_SPAN(3);
  }
}
static_assert(sizeof(RollSmem) <= sizeof(RicSmem), "the rollout's ring fits the sweep's memory");

__global__ void __launch_bounds__(RIC_THREADS, 4)
riccati_sweep_terminal_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                              const float* __restrict__ Mg, const float* __restrict__ qxg,
                              const float* __restrict__ rug, const float* __restrict__ dg,
                              const float* __restrict__ xNg, const float* __restrict__ xrefg,
                              const float* __restrict__ peakg, const float* __restrict__ shg,
                              const float* __restrict__ consts, const float* __restrict__ tw,
                              float* __restrict__ gains, int N, float h, float lm, float reg) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(ric_smem);
  __shared__ float Cs[N_CONSTS];
  __shared__ float Jz[4][18];
  __shared__ float pz[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  RIC_SPAN(0);
  const RicProblem g = ric_problem(Qg, Rg, Mg, qxg, rug, dg, gains, b, N);
  if (N > 0) ric_prefetch(g, N - 1, s, tid);
  for (int i = tid; i < N_CONSTS; i += RIC_THREADS) Cs[i] = consts[i];
  __syncthreads();
  ric_terminal_gram(Cs, xNg + (size_t)b * NX, xrefg + (size_t)b * NX, peakg + b * 4, shg[b],
                    tw, reg, Jz, pz, s, tid, RIC_THREADS);
  ric_sweep(g, N, h, lm, s, tid);
}

__global__ void __launch_bounds__(RIC_THREADS, 4)
riccati_sweep_kernel(const float* __restrict__ Qg, const float* __restrict__ Rg,
                     const float* __restrict__ Mg, const float* __restrict__ qxg,
                     const float* __restrict__ rug, const float* __restrict__ PNg,
                     const float* __restrict__ pNg, const float* __restrict__ dg,
                     float* __restrict__ gains, int N, float h, float lm) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(ric_smem);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const RicProblem g = ric_problem(Qg, Rg, Mg, qxg, rug, dg, gains, b, N);
  if (N > 0) ric_prefetch(g, N - 1, s, tid);
  for (int e = tid; e < NX * NX; e += RIC_THREADS)
    s.P[e / NX][e % NX] = PNg[(size_t)b * NX * NX + e];
  for (int i = tid; i < NX; i += RIC_THREADS) s.pv[i] = pNg[(size_t)b * NX + i];
  ric_sweep(g, N, h, lm, s, tid);   // its first __syncthreads publishes P_N, p_N
}

// one problem a block of one warp
__global__ void __launch_bounds__(32)
forward_rollout_kernel(const float* __restrict__ gains, const float* __restrict__ dg,
                       const float* __restrict__ dx0g, float* __restrict__ dXg,
                       float* __restrict__ dUg, int N, float h) {
  __shared__ RollSmem s;
  const int b = blockIdx.x;
  ric_rollout(gains + (size_t)b * N * NU * NW, dg + (size_t)b * N * NX,
              gains + (size_t)gridDim.x * N * NU * NW, dx0g + (size_t)b * NX,
              dXg + (size_t)b * (N + 1) * NX, dUg + (size_t)b * N * NU, s, N, h, threadIdx.x);
}

// The sweeps' dynamic shared memory (over the 48 KB default), allowed once
// per device.
static cudaError_t ric_configure() {
  static bool known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && known[dev])) return err;
  const void* fns[3] = {(const void*)riccati_rollout_kernel,
                        (const void*)riccati_sweep_terminal_kernel,
                        (const void*)riccati_sweep_kernel};
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(RicSmem));
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) known[dev] = true;
  return cudaSuccess;
}

// The blocks the sweeps copy by 16-byte cp.async must be 16-byte aligned.
static cudaError_t ric_check(const float* Q, const float* R, const float* M, const float* qx,
                             const float* d) {
  const uintptr_t any = (uintptr_t)Q | (uintptr_t)R | (uintptr_t)M | (uintptr_t)qx | (uintptr_t)d;
  if (any & 15) return cudaErrorMisalignedAddress;
  return ric_configure();
}

extern "C" int riccati_rollout_launch(const float* Q, const float* R, const float* M,
                                      const float* qx, const float* ru, const float* d,
                                      const float* dx0, const float* xN, const float* xref,
                                      const float* peak, const float* sh, const float* consts,
                                      const float* tw, float* gains, float* dX, float* dU,
                                      int B, int N, float h, float lm, float reg,
                                      void* stream) {
  const cudaError_t err = ric_check(Q, R, M, qx, d);
  if (err != cudaSuccess) return (int)err;
  riccati_rollout_kernel<<<B, RIC_THREADS, sizeof(RicSmem), (cudaStream_t)stream>>>(
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
  const cudaError_t err = ric_check(Q, R, M, qx, d);
  if (err != cudaSuccess) return (int)err;
  riccati_sweep_terminal_kernel<<<B, RIC_THREADS, sizeof(RicSmem), (cudaStream_t)stream>>>(
      Q, R, M, qx, ru, d, xN, xref, peak, sh, consts, tw, gains, N, h, lm, reg);
  return (int)cudaGetLastError();
}

extern "C" int riccati_sweep_launch(const float* Q, const float* R, const float* M,
                                    const float* qx, const float* ru, const float* PN,
                                    const float* pN, const float* d, float* gains, int B, int N,
                                    float h, float lm, void* stream) {
  const cudaError_t err = ric_check(Q, R, M, qx, d);
  if (err != cudaSuccess) return (int)err;
  riccati_sweep_kernel<<<B, RIC_THREADS, sizeof(RicSmem), (cudaStream_t)stream>>>(
      Q, R, M, qx, ru, PN, pN, d, gains, N, h, lm);
  return (int)cudaGetLastError();
}

// The gains and defects move by bulk copies of 16-byte aligned spans.
extern "C" int forward_rollout_launch(const float* gains, const float* d, const float* dx0,
                                      float* dX, float* dU, int B, int N, float h,
                                      void* stream) {
  if (((uintptr_t)gains | (uintptr_t)d) & 15) return (int)cudaErrorMisalignedAddress;
  forward_rollout_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(gains, d, dx0, dX, dU, N, h);
  return (int)cudaGetLastError();
}

// The compiled kernels' registers a thread, local bytes a thread (stack
// frame and spills) and resident blocks an SM at their launch shape:
// riccati_rollout, riccati_sweep_terminal, riccati_sweep, forward_rollout in
// turn, out[3 k .. 3 k + 2].
extern "C" int riccati_attributes(int* out) {
  cudaError_t err = ric_configure();
  if (err != cudaSuccess) return (int)err;
  const void* fns[4] = {(const void*)riccati_rollout_kernel,
                        (const void*)riccati_sweep_terminal_kernel,
                        (const void*)riccati_sweep_kernel, (const void*)forward_rollout_kernel};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fns[k], k < 3 ? RIC_THREADS : 32, k < 3 ? sizeof(RicSmem) : 0);
    if (err != cudaSuccess) return (int)err;
    out[3 * k] = a.numRegs;
    out[3 * k + 1] = (int)a.localSizeBytes;
    out[3 * k + 2] = blocks;
  }
  return 0;
}

#ifdef RIC_TRACE
// The trace buffers: n stamps (RIC_STAMPS per (block, node), block-major)
// and n spans (8 per block: clock64 and %globaltimer at the kernel's start,
// the sweep's start and end, and the rollout's end).
extern "C" int ric_read_stamps(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ric_stamps, (size_t)n * 8);
}
extern "C" int ric_read_spans(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ric_spans, (size_t)n * 8);
}
#endif
