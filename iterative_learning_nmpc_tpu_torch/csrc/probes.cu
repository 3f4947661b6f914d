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
//   node_solve_warp    persistent warps that eliminate pivot by pivot in
//                      registers. Replaces _kernel_sublane of
//                      scripts/proto_sublane_riccati.py (:149, called at
//                      :179; its body _solve_node_sublane, :100): Cholesky
//                      pivot by pivot on the shrinking submatrix, the
//                      forward solve with it, the value update as a sum of
//                      30 outer products. Design (what bounds it is below):
//                      the grid is as many 5-warp blocks as the card holds
//                      (22,720 B of shared memory a warp: 2 blocks, 10 warps
//                      an SM), each warp walking nodes first, first + all
//                      warps, ...; lane i owns row i of Quu and column i of
//                      [Qux | qu] in registers (columns 32..36 as 5 floats
//                      of row i), and each pivot broadcasts one column of L
//                      (one store a lane, float4 loads after a __syncwarp)
//                      that updates both, so W = L^{-1} [Qux | qu] is done
//                      when Quu is factored; the back substitution reads
//                      columns of L (dot products, every index static);
//                      the value update forms only the lower triangle (21
//                      6x6 register tiles, mirrored on the store, so P - Qxx
//                      is exactly symmetric; 6 lanes form p); K, P, p leave
//                      through shared memory as float4 rows. The next
//                      node's Quu, Qux, qu land in shared memory by cp.async
//                      while this node's are in registers, its Qxx, qxp
//                      while this node is eliminated. On the card the
//                      shared-memory data path, not device memory, is what
//                      limits it (128 B a cycle an SM, a broadcast float4
//                      load costing 4 cycles as 32 distinct floats do):
//                      ~2.4 k of its cycles a node, which lane i owning row
//                      i of all of [Quu | Qux | qu] (37 right-hand sides
//                      broadcast a pivot) had doubled (PERF.md).
//   node_solve_thread  one thread per (problem, node) over a batch-innermost
//                      layout (d1, d2, L): neighbouring threads read
//                      neighbouring addresses; static unrolled indices, no
//                      masks or syncs; L (465 floats packed) and W (30 x 37)
//                      per thread exceed the 255 registers, so part lives
//                      in local memory (168 registers, 7,040 B of stack, by
//                      nvcc -Xptxas -v). The GPU analogue of _kernel_sublane
//                      kept as it is: one thread a node cannot hold a
//                      node's L and W, whatever the code, so this mapping
//                      is the baseline the warp mapping is measured against.
//
// Every node solve computes, from Qxx (36x36), Quu (30x30), Qux (30x36),
// qxp (36), qu (30): Quu = L L^T (pivot floor rsqrt(max(d, 1e-30))),
// W = L^{-1} [Qux | qu], Z = L^{-T} W, K = -Z_x, kff = -Z_f,
// P = Qxx - W_x^T W_x, p = qxp - W_x^T w_f. Bound: the bytes (13,368 in,
// 9,768 out per node: 23,136) at 3.35 TB/s over the 1.26e5 algorithmic
// flops at 67 TFLOP/s: bytes, by 3.7x (0.1768 ms at M = 25,600 nodes).
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

// ---- node_solve_warp: persistent warps, eliminating pivot by pivot in registers ----
#define NSW_WARPS 5      // warps a block: two blocks (10 warps) an SM by shared memory
#define NSW_QUX 900      // offsets in a warp's input buffer (floats): Quu | Qux | qu
#define NSW_QU 1980
#define NSW_A 2012
#define NSW_B (NX * NX + NX)   // Qxx | qxp, then P | p in place
#define NSW_RS 40        // row stride of R: rows start on 16-byte bounds

struct NswSmem {                  // one warp's, 22,720 bytes (every part 16-byte aligned)
  alignas(16) float a[NSW_A];     // Quu, Qux, qu of the warp's next node, in flight
  alignas(16) float b[NSW_B];     // Qxx, qxp of its node, then P, p for the store
  alignas(16) float Lf[NU][32];   // Lf[k][m] = L[k+1+m][k], column k below the diagonal
  alignas(16) float R[32][NSW_RS];   // W (row k at pivot k), then -Z = [K | kff]
  alignas(16) float rs[32];       // 1 / L[k][k]
  alignas(16) float dg[2][32];    // lane k+1's next diagonal, by pivot parity
};

extern __shared__ __align__(16) unsigned char nsw_smem[];

// Compiled with -DNSW_TRACE (scripts/proto_node_solve_torch.py --trace), lane
// 0 of each warp writes clock64() at seven points of each node m <
// NSW_STAMP_NODES it solves: its start, its rows and columns in registers
// (the wait for Quu, Qux, qu included), the elimination's end, Qxx landed, P
// and p stored, the back substitution's end, K stored. The shipped build has
// none.
#ifdef NSW_TRACE
#define NSW_STAMPS 7
#define NSW_STAMP_NODES (1 << 17)
__device__ long long nsw_stamps[NSW_STAMP_NODES * NSW_STAMPS];
#define NSW_STAMP(i)                                                    \
  do {                                                                  \
    __syncwarp();                                                       \
    const long long c_ = clock64();                                     \
    if (lane == 0 && m < NSW_STAMP_NODES) nsw_stamps[m * NSW_STAMPS + (i)] = c_; \
  } while (0)
extern "C" int nsw_read_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, nsw_stamps, (size_t)n * sizeof(long long));
}
#else
#define NSW_STAMP(i) \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ void nsw_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// every group but the last committed has landed (this lane's copies)
__device__ __forceinline__ void nsw_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// node m's Quu, Qux (16-byte copies: per-node offsets of 3,600 and 4,320 B)
// and qu (4-byte copies: 120 B a node) into a, one group
__device__ __forceinline__ void nsw_fetch_a(float* a, const float* Quu, const float* Qux,
                                            const float* qu, size_t m, int lane) {
  const float* q = Quu + m * NU * NU;
  const float* x = Qux + m * NU * NX;
  for (int c = lane; c < NU * NU / 4; c += 32) ric_cp16(a + 4 * c, q + 4 * c);
  for (int c = lane; c < NU * NX / 4; c += 32) ric_cp16(a + NSW_QUX + 4 * c, x + 4 * c);
  if (lane < NU) ric_cp4(a + NSW_QU + lane, qu + m * NU + lane);
  nsw_commit();
}

// node m's Qxx and qxp (16-byte copies: 5,184 and 144 B a node) into b, one group
__device__ __forceinline__ void nsw_fetch_b(float* b, const float* Qxx, const float* qxp,
                                            size_t m, int lane) {
  const float* q = Qxx + m * NX * NX;
  for (int c = lane; c < NX * NX / 4; c += 32) ric_cp16(b + 4 * c, q + 4 * c);
  if (lane < NX / 4) ric_cp16(b + NX * NX + 4 * lane, qxp + m * NX + 4 * lane);
  nsw_commit();
}

// Pivot k. Lane i holds three things in registers, each moving pivot by
// pivot: a[0 .. 29 - k], row i's columns k .. 29 of the trailing matrix of
// Quu (lanes 30, 31: zeros); b[0 .. 29 - k], rows k .. 29 of column i of the
// right-hand sides [Qux | qu] (lanes 0..31: columns 0..31); e[], row i's
// right-hand sides in columns 32..36 (four of Qux, qu). a and b move one
// register left a pivot, so every register index is static (as in
// ric_pivot). r = rsqrt(max(d, 1e-30)) from the pivot d (the TPU kernel's
// floor); lane i stores L[i][k] = a[0] r to Lf[k] (all 32 lanes: a
// permutation, the tail junk), lane k+1 its next pivot to dg, every lane
// W[k][i] = b[0] r to R[k][i], and lane k W[k][32..36] = e r. After one
// __syncwarp one broadcast column of L serves both updates (a[j] -= L[i][k]
// L[k+1+j][k], b[j] -= W[k][i] L[k+1+j][k], for J >= 29 - k rows), and the
// rows below the pivot take e -= L[i][k] W[k][32..36] (a select, not a
// product, keeps the others: their a is junk).
template <int J>
__device__ __forceinline__ void nsw_pivot(float (&a)[NU], float (&b)[NU], float (&e)[5],
                                          int lane, int k, float& d, float& myr, NswSmem& s) {
  const float r = rsqrtf(fmaxf(d, 1e-30f));
  const float lk = a[0] * r, wk = b[0] * r;
  s.Lf[k][(lane - k - 1) & 31] = lk;
  s.dg[k & 1][lane] = fmaf(-lk, lk, a[1]);
  s.R[k][lane] = wk;
  if (lane == k) {
    myr = r;
    *reinterpret_cast<float4*>(&s.R[k][32]) = make_float4(e[0] * r, e[1] * r, e[2] * r, e[3] * r);
    s.R[k][NX] = e[4] * r;
  }
  __syncwarp();
  d = s.dg[k & 1][(k + 1) & 31];
#pragma unroll
  for (int q = 0; q < (J + 3) / 4; ++q) {
    const float4 l = *reinterpret_cast<const float4*>(&s.Lf[k][4 * q]);
    const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < J) {
        const int j = 4 * q + m, n = j < J ? j + 1 : 0;
        a[j] = fmaf(-lk, lq[m], a[n]);
        b[j] = fmaf(-wk, lq[m], b[n]);
      }
  }
  const float4 v = *reinterpret_cast<const float4*>(&s.R[k][32]);
  const float cf = lane > k ? lk : 0.f;
  e[0] = fmaf(-cf, v.x, e[0]);
  e[1] = fmaf(-cf, v.y, e[1]);
  e[2] = fmaf(-cf, v.z, e[2]);
  e[3] = fmaf(-cf, v.w, e[3]);
  e[4] = fmaf(-cf, s.R[k][NX], e[4]);
}

// Six pivots k0 .. k0 + 5 with J = 29 - k0 rows of the broadcast column.
template <int K0>
__device__ __forceinline__ void nsw_pivots(float (&a)[NU], float (&b)[NU], float (&e)[5],
                                           int lane, float& d, float& myr, NswSmem& s) {
#pragma unroll 2
  for (int k = K0; k < K0 + 6; ++k) nsw_pivot<NU - 1 - K0>(a, b, e, lane, k, d, myr, s);
}

// Step k (descending) of Z = L^{-T} W, a template so that every register
// index is static: lane i's column i, z_k = (w_k - sum_{j>k} L[j][k] z_j)
// r_k, by a dot product with column k of L (Lf[k], broadcast float4s; two
// partial sums) into b[k]; the columns 32..36 by rows: lane k's e is final,
// and goes to R[k] as -Z, and the rows above take L[k][i] of it (one
// __syncwarp).
template <int k>
__device__ __forceinline__ void nsw_back(float (&b)[NU], float (&e)[5], int lane, int row,
                                         NswSmem& s) {
  const float rk = s.rs[k];
  float s0 = b[k], s1 = 0.f;
#pragma unroll
  for (int q = 0; q < (NU + 2 - k) / 4; ++q) {
    const float4 l = *reinterpret_cast<const float4*>(&s.Lf[k][4 * q]);
    const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = k + 1 + 4 * q + m;
      if (j < NU) {
        if (m & 1) s1 = fmaf(-lq[m], b[j < NU ? j : 0], s1);
        else s0 = fmaf(-lq[m], b[j < NU ? j : 0], s0);
      }
    }
  }
  b[k] = (s0 + s1) * rk;
  if (lane == k) {
    *reinterpret_cast<float4*>(&s.R[k][32]) = make_float4(-e[0] * rk, -e[1] * rk, -e[2] * rk, -e[3] * rk);
    s.R[k][NX] = -e[4] * rk;
  }
  const float lki = s.Lf[row][(k - 1 - lane) & 31];   // L[k][lane] for lane < k
  __syncwarp();
  const float4 v = *reinterpret_cast<const float4*>(&s.R[k][32]);
  const float cf = lane < k ? lki : 0.f;
  e[0] = fmaf(cf, v.x, e[0]);
  e[1] = fmaf(cf, v.y, e[1]);
  e[2] = fmaf(cf, v.z, e[2]);
  e[3] = fmaf(cf, v.w, e[3]);
  e[4] = fmaf(cf, s.R[k][NX], e[4]);
  if constexpr (k > 0) nsw_back<k - 1>(b, e, lane, row, s);
}

__global__ void __launch_bounds__(32 * NSW_WARPS, 2)
node_solve_warp_kernel(const float* __restrict__ Qxx, const float* __restrict__ Quu,
                       const float* __restrict__ Qux, const float* __restrict__ qxp,
                       const float* __restrict__ qu, float* __restrict__ K,
                       float* __restrict__ kff, float* __restrict__ P, float* __restrict__ p,
                       int M) {
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t first = (size_t)blockIdx.x * NSW_WARPS + wid, stride = (size_t)gridDim.x * NSW_WARPS;
  if (first >= (size_t)M) return;   // whole warps only: a warp synchronizes alone
  NswSmem& s = reinterpret_cast<NswSmem*>(nsw_smem)[wid];
  const int row = lane < NU ? lane : NU - 1;   // lanes 30, 31 carry zeros as rows
  const float live = lane < NU ? 1.f : 0.f;
  // the value update's tile: lanes 0..20 the 6x6 tile (ti, tj), ti >= tj, of
  // W_x^T W_x (21 tiles: its lower triangle); lanes 21..26 the 6x1 block ti
  // of W_x^T w_f (y read from column 36 on; only acc[a][0] is kept); lanes
  // 27..31 repeat tile 0 and store nothing
  int ti = 0, tj = 0;
  if (lane < 21) ric_tile_of(lane, ti, tj);
  else if (lane < 27) ti = lane - 21;
  const int ci = 6 * ti, cj = lane >= 21 && lane < 27 ? NX : 6 * tj;

  nsw_fetch_a(s.a, Quu, Qux, qu, first, lane);
  nsw_fetch_b(s.b, Qxx, qxp, first, lane);
  for (size_t m = first; m < (size_t)M; m += stride) {
    const size_t mn = m + stride;
    NSW_STAMP(0);
    // node m's rows and columns into registers, then the next node's blocks
    // into the buffer
    nsw_wait_prev();
    __syncwarp();
    float a[NU], b[NU], e[5];
#pragma unroll
    for (int j = 0; j < NU; j += 2) {
      const float2 v = *reinterpret_cast<const float2*>(&s.a[row * NU + j]);
      a[j] = live * v.x;
      a[j + 1] = live * v.y;
    }
#pragma unroll
    for (int k = 0; k < NU; ++k) b[k] = s.a[NSW_QUX + k * NX + lane];
    {
      const float4 v = *reinterpret_cast<const float4*>(&s.a[NSW_QUX + row * NX + 32]);
      e[0] = live * v.x;
      e[1] = live * v.y;
      e[2] = live * v.z;
      e[3] = live * v.w;
      e[4] = live * s.a[NSW_QU + row];
    }
    NSW_STAMP(1);
    __syncwarp();
    if (mn < (size_t)M) nsw_fetch_a(s.a, Quu, Qux, qu, mn, lane);
    else nsw_commit();

    // Quu = L L^T and W = L^{-1} [Qux | qu] into R, pivot by pivot
    float myr = 0.f;
    float d = __shfl_sync(0xffffffffu, a[0], 0);
    nsw_pivots<0>(a, b, e, lane, d, myr, s);
    nsw_pivots<6>(a, b, e, lane, d, myr, s);
    nsw_pivots<12>(a, b, e, lane, d, myr, s);
    nsw_pivots<18>(a, b, e, lane, d, myr, s);
    nsw_pivots<24>(a, b, e, lane, d, myr, s);
    s.rs[lane] = myr;
    NSW_STAMP(2);

    // P = Qxx - W_x^T W_x on the lower triangle, mirrored; p = qxp - W_x^T w_f
    nsw_wait_prev();   // node m's Qxx, qxp
    __syncwarp();      // and W, rs
    NSW_STAMP(3);
    {
      float acc[6][6] = {};
#pragma unroll 2
      for (int k = 0; k < NU; ++k) {
        float x[6], y[6];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float2 u = *reinterpret_cast<const float2*>(&s.R[k][ci + 2 * q]);
          const float2 v = *reinterpret_cast<const float2*>(&s.R[k][cj + 2 * q]);
          x[2 * q] = u.x;
          x[2 * q + 1] = u.y;
          y[2 * q] = v.x;
          y[2 * q + 1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
      if (lane < 21) {
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) s.b[(ci + i) * NX + cj + j] -= acc[i][j];
        if (ti != tj) {   // the mirror (a diagonal tile holds both halves)
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) s.b[(cj + j) * NX + ci + i] -= acc[i][j];
        }
      } else if (lane < 27) {
#pragma unroll
        for (int i = 0; i < 6; ++i) s.b[NX * NX + ci + i] -= acc[i][0];
      }
    }
    __syncwarp();
    for (int c = lane; c < NX * NX / 4; c += 32)
      *reinterpret_cast<float4*>(P + m * NX * NX + 4 * c) = *reinterpret_cast<const float4*>(&s.b[4 * c]);
    if (lane < NX / 4)
      *reinterpret_cast<float4*>(p + m * NX + 4 * lane) =
          *reinterpret_cast<const float4*>(&s.b[NX * NX + 4 * lane]);
    __syncwarp();
    NSW_STAMP(4);
    if (mn < (size_t)M) nsw_fetch_b(s.b, Qxx, qxp, mn, lane);
    else nsw_commit();

    // Z = L^{-T} W from the last row up: W's columns and rows back from R
#pragma unroll
    for (int k = 0; k < NU; ++k) b[k] = s.R[k][lane];
    {
      const float4 v = *reinterpret_cast<const float4*>(&s.R[row][32]);
      e[0] = live * v.x;
      e[1] = live * v.y;
      e[2] = live * v.z;
      e[3] = live * v.w;
      e[4] = live * s.R[row][NX];
    }
    nsw_back<NU - 1>(b, e, lane, row, s);
#pragma unroll
    for (int k = 0; k < NU; ++k) s.R[k][lane] = -b[k];
    __syncwarp();
    NSW_STAMP(5);
    if (lane < NU) kff[m * NU + lane] = s.R[lane][NX];
    for (int c = lane; c < NU * NX / 4; c += 32) {
      const int i = c / (NX / 4), q = c - i * (NX / 4);
      *reinterpret_cast<float4*>(K + m * NU * NX + 4 * c) =
          *reinterpret_cast<const float4*>(&s.R[i][4 * q]);
    }
    NSW_STAMP(6);
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

// The grid: as many blocks as the card holds at once (the occupancy of
// NSW_WARPS warps with their shared memory, read once per device), at most
// one warp a node; each warp walks nodes first, first + all warps, ...
// Quu, Qux, Qxx, qxp move by 16-byte cp.async and K, P, p by float4
// stores: they must be 16-byte aligned.
extern "C" int node_solve_warp_launch(const float* Qxx, const float* Quu, const float* Qux,
                                      const float* qxp, const float* qu, float* K, float* kff,
                                      float* P, float* p, int M, void* stream) {
  static int resident[64] = {};   // blocks the card holds at once, per device
  const int smem = NSW_WARPS * (int)sizeof(NswSmem);
  if (((uintptr_t)Qxx | (uintptr_t)Quu | (uintptr_t)Qux | (uintptr_t)qxp | (uintptr_t)K |
       (uintptr_t)P | (uintptr_t)p) & 15)
    return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < 64 ? resident[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute((const void*)node_solve_warp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, node_solve_warp_kernel,
                                                          32 * NSW_WARPS, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    if (dev < 64) resident[dev] = blocks;
  }
  const int need = (M + NSW_WARPS - 1) / NSW_WARPS;
  node_solve_warp_kernel<<<need < blocks ? need : blocks, 32 * NSW_WARPS, smem,
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
