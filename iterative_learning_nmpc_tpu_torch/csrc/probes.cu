// Probes of the card: an fp32 FMA ceiling and three thread mappings of one
// Riccati node's factorize-and-solve.
//
//   fma_chain          out[i] = sum_k x_k after `iters` steps of
//                      x_k <- x_k b[i] + b[i], x_k(0) = a[i] (1 + 0.001 k),
//                      k < nacc: 2 n iters nacc flops and 8 n + 4 n bytes,
//                      so it is bound by the FMA rate. Replaces the probe
//                      `kern` of scripts/roofline.py:vpu_peak_tflops (a
//                      Pallas kernel at :133). Each thread runs nacc
//                      independent chains (unrolled) so that the four
//                      cycles of FMA latency hide behind the other chains
//                      and the other resident warps; the caller sizes the
//                      grid to whole waves of the 132 SMs.
//   node_solve_block   one block of RIC_THREADS threads per (problem, node):
//                      the production node stage of riccati.cuh, as kernels
//                      3, 4 and 6 run it (ric_factor on the factor warp,
//                      ric_forward, ric_backward and ric_value_p on the
//                      column threads, ric_value_tile on the tile threads;
//                      three __syncthreads), the blocks read from global
//                      memory instead of formed from P. Replaces
//                      _kernel_lanes of scripts/proto_sublane_riccati.py
//                      (the production TPU layout, :48, called at :70).
//   node_solve_warp    one warp per (problem, node), matrices in shared
//                      memory, each pivot resolved within the warp with
//                      __syncwarp only: lane i owns row k + 1 + i of the
//                      trailing update, and lane c the right-hand-side
//                      columns c and c + 32.
//   node_solve_thread  one thread per (problem, node) over a batch-innermost
//                      layout (d1, d2, L): neighbouring threads read
//                      neighbouring addresses; static unrolled indices, no
//                      masks or syncs; L (465 floats packed) and W (30 x 37)
//                      per thread exceed the 255 registers, so part lives
//                      in local memory. The GPU analogue of _kernel_sublane
//                      (scripts/proto_sublane_riccati.py:149, called at :179).
//
// Every node solve computes, from Qxx (36x36), Quu (30x30), Qux (30x36),
// qxp (36), qu (30): Quu = L L^T (pivot floor rsqrt(max(d, 1e-30))),
// W = L^{-1} [Qux | qu], Z = L^{-T} W, K = -Z_x, kff = -Z_f,
// P = Qxx - W_x^T W_x, p = qxp - W_x^T w_f. Bound: the bytes (13,368 in,
// 9,768 out per node) at 3.35 TB/s over the 1.26e5 algorithmic flops at
// 67 TFLOP/s: bytes, by 3.7x.
#include "riccati.cuh"

// ---- fma_chain ----
template <int NACC>
__global__ void __launch_bounds__(256)
fma_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float av = a[i], bv = b[i];
  float x[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) x[k] = av * (1.0f + 0.001f * (float)k);
#pragma unroll 8
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < NACC; ++k) x[k] = fmaf(x[k], bv, bv);
  float acc = x[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) acc += x[k];
  out[i] = acc;
}

extern "C" int fma_chain_launch(const float* a, const float* b, float* out, int n,
                                int iters, int nacc, void* stream) {
  const int grid = (n + 255) / 256;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nacc) {
    case 1: fma_chain_kernel<1><<<grid, 256, 0, st>>>(a, b, out, n, iters); break;
    case 2: fma_chain_kernel<2><<<grid, 256, 0, st>>>(a, b, out, n, iters); break;
    case 4: fma_chain_kernel<4><<<grid, 256, 0, st>>>(a, b, out, n, iters); break;
    case 8: fma_chain_kernel<8><<<grid, 256, 0, st>>>(a, b, out, n, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- node_solve_block: the production stage ----
extern __shared__ __align__(16) unsigned char nsb_smem[];

__global__ void __launch_bounds__(RIC_THREADS)
node_solve_block_kernel(const float* __restrict__ Qxx, const float* __restrict__ Quu,
                        const float* __restrict__ Qux, const float* __restrict__ qxp,
                        const float* __restrict__ qu, float* __restrict__ K,
                        float* __restrict__ kff, float* __restrict__ P,
                        float* __restrict__ p) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(nsb_smem);
  float* G = s.in[0];   // [K | kff], 30 x 37
  const size_t m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid - RIC_COL0, t = tid - RIC_TILE0;
  int ti = 0, tj = 0;
  float w[NU], lo[NU], up[NU];   // lo[3 a + b] = Qxx[i][j], up[3 a + b] = Qxx[j][i]
  if (warp == 0) {
    float a[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) a[j] = lane < NU ? Quu[(m * NU + lane) * NU + j] : 0.f;
    ric_factor(a, lane, s.Lf, s.Lb[0], s.rs[0], s.dg);
  } else if (warp < 3) {
    if (c < NU) s.Wm[c][NX] = qu[m * NU + c];
    if (c < NX) s.qxp[c] = qxp[m * NX + c];
  } else {
    if (t < RIC_TILES) {
      ric_tile_of(t, ti, tj);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int i = 3 * ti + a, j = 3 * tj + b;
          lo[3 * a + b] = Qxx[(m * NX + i) * NX + j];
          up[3 * a + b] = Qxx[(m * NX + j) * NX + i];
        }
    }
    for (int e = t; e < NU * NX; e += RIC_THREADS - RIC_TILE0)
      s.Wm[e / NX][e % NX] = Qux[m * NU * NX + e];
  }
  __syncthreads();
  const bool column = warp >= 1 && warp < 3 && c < NW;
  if (column) ric_forward(w, c, s.Wm, s.Lf, s.rs[0]);
  __syncthreads();
  if (column) {
    ric_backward(w, c, s.Lb[0], s.rs[0], G);
    if (c < NX) ric_value_p(c, s.Wm, s.qxp, s.pv);
  } else if (warp >= 3 && t < RIC_TILES) {
    ric_value_tile(lo, up, ti, tj, s.Wm, s.P);
  }
  __syncthreads();
  for (int e = tid; e < NU * NX; e += RIC_THREADS) K[m * NU * NX + e] = G[(e / NX) * NW + e % NX];
  for (int i = tid; i < NU; i += RIC_THREADS) kff[m * NU + i] = G[i * NW + NX];
  for (int e = tid; e < NX * NX; e += RIC_THREADS) P[m * NX * NX + e] = s.P[e / NX][e % NX];
  for (int i = tid; i < NX; i += RIC_THREADS) p[m * NX + i] = s.pv[i];
}

// ---- node_solve_warp ----
#define NSW_WARPS 4

struct WarpSolveSmem {   // 8,280 bytes per warp
  float L[NU][NU + 1];   // + 1: lanes on consecutive rows hit distinct banks
  float Wm[NU][NW];
  float rs[NU];
};

__global__ void __launch_bounds__(32 * NSW_WARPS)
node_solve_warp_kernel(const float* __restrict__ Qxx, const float* __restrict__ Quu,
                       const float* __restrict__ Qux, const float* __restrict__ qxp,
                       const float* __restrict__ qu, float* __restrict__ K,
                       float* __restrict__ kff, float* __restrict__ P, float* __restrict__ p,
                       int M) {
  __shared__ WarpSolveSmem sm[NSW_WARPS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t m = (size_t)blockIdx.x * NSW_WARPS + w;
  if (m >= (size_t)M) return;   // whole warps only: the warp synchronizes alone
  WarpSolveSmem& s = sm[w];
  for (int e = lane; e < NU * NU; e += 32) s.L[e / NU][e % NU] = Quu[m * NU * NU + e];
  for (int e = lane; e < NU * NX; e += 32) s.Wm[e / NX][e % NX] = Qux[m * NU * NX + e];
  if (lane < NU) s.Wm[lane][NX] = qu[m * NU + lane];
  __syncwarp();

  // right-looking Cholesky in place (lower triangle)
  for (int k = 0; k < NU; ++k) {
    const float dkk = s.L[k][k];
    const float r = rsqrtf(fmaxf(dkk, 1e-30f));
    const int i = k + 1 + lane;
    float lik = 0.f;
    if (i < NU) {
      lik = s.L[i][k] * r;
      s.L[i][k] = lik;
    }
    __syncwarp();
    if (lane == 0) {
      s.rs[k] = r;
      s.L[k][k] = dkk * r;
    }
    if (i < NU)
      for (int j = k + 1; j <= i; ++j) s.L[i][j] -= lik * s.L[j][k];
    __syncwarp();
  }

  // per right-hand-side column: W = L^{-1} [Qux | qu] in place, Z = L^{-T} W
  for (int c = lane; c < NW; c += 32) {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      float v = s.Wm[k][c];
#pragma unroll
      for (int j = 0; j < k; ++j) v -= s.L[k][j] * s.Wm[j][c];
      s.Wm[k][c] = v * s.rs[k];
    }
    float z[NU];
#pragma unroll
    for (int k = NU - 1; k >= 0; --k) {
      float v = s.Wm[k][c];
#pragma unroll
      for (int j = k + 1; j < NU; ++j) v -= s.L[j][k] * z[j];
      z[k] = v * s.rs[k];
    }
    if (c < NX) {
#pragma unroll
      for (int k = 0; k < NU; ++k) K[m * NU * NX + k * NX + c] = -z[k];
    } else {
#pragma unroll
      for (int k = 0; k < NU; ++k) kff[m * NU + k] = -z[k];
    }
  }
  __syncwarp();

  // value update: P = Qxx - W_x^T W_x (symmetric), p = qxp - W_x^T w_f
  for (int e = lane; e < NX * NX; e += 32) {
    const int i = e / NX, j = e % NX;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < NU; ++k) v += s.Wm[k][lo] * s.Wm[k][hi];
    P[m * NX * NX + e] = Qxx[m * NX * NX + e] - v;
  }
  for (int i = lane; i < NX; i += 32) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < NU; ++k) v += s.Wm[k][i] * s.Wm[k][NX];
    p[m * NX + i] = qxp[m * NX + i] - v;
  }
}

// ---- node_solve_thread: batch-innermost layout ----
// element e of a (d1, d2, Lt) or (d, Lt) array, for this thread's node m
#define AT(arr, e) arr[(size_t)(e) * Lt + m]
#define TRI(i, j) ((i) * ((i) + 1) / 2 + (j))

__global__ void __launch_bounds__(128)
node_solve_thread_kernel(const float* __restrict__ Qxx, const float* __restrict__ Quu,
                         const float* __restrict__ Qux, const float* __restrict__ qxp,
                         const float* __restrict__ qu, float* __restrict__ K,
                         float* __restrict__ kff, float* __restrict__ P,
                         float* __restrict__ p, int Lt) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Lt) return;
  float L[TRI(NU, 0)];     // packed lower triangle
  float rs[NU];
  float W[NU * NW];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) L[TRI(i, j)] = AT(Quu, i * NU + j);

  // right-looking Cholesky, every index static
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const float dkk = L[TRI(k, k)];
    const float r = rsqrtf(fmaxf(dkk, 1e-30f));
    rs[k] = r;
    L[TRI(k, k)] = dkk * r;
#pragma unroll
    for (int i = k + 1; i < NU; ++i) L[TRI(i, k)] *= r;
#pragma unroll
    for (int i = k + 1; i < NU; ++i)
#pragma unroll
      for (int j = k + 1; j <= i; ++j) L[TRI(i, j)] -= L[TRI(i, k)] * L[TRI(j, k)];
  }

  // one right-hand-side column at a time: y = L^{-1} rhs, z = L^{-T} y
#pragma unroll 1
  for (int c = 0; c < NW; ++c) {
    float y[NU], z[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      float v = c < NX ? AT(Qux, k * NX + c) : AT(qu, k);
#pragma unroll
      for (int j = 0; j < k; ++j) v -= L[TRI(k, j)] * y[j];
      y[k] = v * rs[k];
      W[k * NW + c] = y[k];
    }
#pragma unroll
    for (int k = NU - 1; k >= 0; --k) {
      float v = y[k];
#pragma unroll
      for (int j = k + 1; j < NU; ++j) v -= L[TRI(j, k)] * z[j];
      z[k] = v * rs[k];
    }
    if (c < NX) {
#pragma unroll
      for (int k = 0; k < NU; ++k) AT(K, k * NX + c) = -z[k];
    } else {
#pragma unroll
      for (int k = 0; k < NU; ++k) AT(kff, k) = -z[k];
    }
  }

  // value update over the lower triangle, mirrored
#pragma unroll 1
  for (int i = 0; i < NX; ++i) {
#pragma unroll 1
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < NU; ++k) v += W[k * NW + j] * W[k * NW + i];
      AT(P, i * NX + j) = AT(Qxx, i * NX + j) - v;
      if (j < i) AT(P, j * NX + i) = AT(Qxx, j * NX + i) - v;
    }
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < NU; ++k) v += W[k * NW + i] * W[k * NW + NX];
    AT(p, i) = AT(qxp, i) - v;
  }
}
#undef AT
#undef TRI

extern "C" int node_solve_block_launch(const float* Qxx, const float* Quu, const float* Qux,
                                       const float* qxp, const float* qu, float* K,
                                       float* kff, float* P, float* p, int M, void* stream) {
  static bool known[64] = {};   // the stage's shared memory, allowed once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < 64 && known[dev])) {
    err = cudaFuncSetAttribute((const void*)node_solve_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(RicSmem));
    if (err == cudaSuccess && dev < 64) known[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  node_solve_block_kernel<<<M, RIC_THREADS, sizeof(RicSmem), (cudaStream_t)stream>>>(
      Qxx, Quu, Qux, qxp, qu, K, kff, P, p);
  return (int)cudaGetLastError();
}

extern "C" int node_solve_warp_launch(const float* Qxx, const float* Quu, const float* Qux,
                                      const float* qxp, const float* qu, float* K, float* kff,
                                      float* P, float* p, int M, void* stream) {
  node_solve_warp_kernel<<<(M + NSW_WARPS - 1) / NSW_WARPS, 32 * NSW_WARPS, 0,
                           (cudaStream_t)stream>>>(Qxx, Quu, Qux, qxp, qu, K, kff, P, p, M);
  return (int)cudaGetLastError();
}

extern "C" int node_solve_thread_launch(const float* Qxx, const float* Quu, const float* Qux,
                                        const float* qxp, const float* qu, float* K,
                                        float* kff, float* P, float* p, int Lt, void* stream) {
  node_solve_thread_kernel<<<(Lt + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      Qxx, Quu, Qux, qxp, qu, K, kff, P, p, Lt);
  return (int)cudaGetLastError();
}
