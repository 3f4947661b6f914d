// The stages of the structured Riccati solve, as __device__ functions shared
// by the kernels of riccati.cu (3, 4, 6) and the node-solve probe of
// probes.cu:
//
//   ric_terminal_gram  the terminal value function (P_N, p_N) from the
//                      q-only dual FK of the terminal state,
//   ric_sweep          the backward sweep over a problem's N nodes: the
//                      node stage below, pipelined over the nodes, gains
//                      [K | kff] to global memory,
//   ric_rollout        the alpha = 1 affine rollout over [K | kff], by one
//                      warp, the gains streamed ahead through shared memory.
//
// Math: iterative_learning_nmpc_tpu/solver/sqp.py _riccati_solve_structured
// + _forward_delta_structured with the constant double-integrator
// A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]]: every product with A/B
// is a block scale-add. Each stage has one arithmetic order, whichever
// kernel runs it, so the fused kernel and the split chain agree bit for bit.
//
// The node stage (replaces the TPU kernel's masked rank-1 loops of
// ops/riccati_kernel.py:329-385). A node is a chain of small dependent
// steps (~72 k MACs), so its time is the latency of that chain, not the
// SM's throughput. A block of six warps, one problem, each warp a role:
//
//   warp 0     factor: forms its row of Quu = R + lm I + B^T P B in
//              registers (lane i, row i) and factors it there, every index
//              static, no block barrier; pivot k's column goes to the other
//              lanes through shared memory (one store a lane, broadcast
//              float4 loads, __syncwarp: on the card half the time of a
//              shuffle per column entry, scripts/bench_riccati_phases.py);
//              writes L in two layouts (Lf, Lb) and the pivots' reciprocals;
//   warps 1-2  columns: thread c < 37 owns column c of [Qux | qu]; forms
//              P d + p, qu and qxp; solves W = L^{-1} [Qux | qu] (the
//              forward solve, W back to shared memory) and Z = L^{-T} W
//              (the backward solve, -Z to the gains) in registers, L read
//              as broadcast float4 rows; updates p <- qxp - W_x^T w_f;
//   warps 3-5  tiles: thread t < 78 owns a 3x3 tile of the lower triangle
//              of the 36x36 value matrix; it forms its tile of
//              Qxx = Q + A^T P A in registers, and after the solve the
//              tile of P <- Qxx - W_x^T W_x, mirrored (P stays exactly
//              symmetric); all 96 form Qux = M^T + B^T P A.
//
// Node n: [A] warp 0 factors while the columns run the backward solve of
// node n+1 (off the critical path: its Lb and r are double-buffered) and
// form P d + p, qu, qxp, and the tiles form Qxx and Qux; [B] forward solve;
// [C] value update; [A] next node. Three __syncthreads and one 64-thread
// named barrier (warps 1-2) a node. Node n-1's inputs (Q, R, M, qx, ru, d:
// 13.5 KB) stream into the other half of a double buffer by cp.async while
// node n runs, so no node waits on global memory; Q is read from shared
// memory in either orientation, so the global reads are plain rows. The
// loops are rolled (a register row moves one slot a step, so indices stay
// static) and the per-element code has no branch: fully unrolled code
// (10-13 k instructions) ran out of the instruction cache every node.
#pragma once
#include <stdint.h>

#include "legdyn.cuh"

#define NX 36
#define NU 30
#define NW 37   // [Qux | qu] columns; the gains are [K | kff] (NU x NW)

#define RIC_THREADS 192
#define RIC_COL0 32     // column threads: tid 32..68, column c = tid - 32
#define RIC_TILE0 96    // tile threads: tid 96..191, t = tid - 96
#define RIC_TILES 78    // 3x3 tiles of the lower triangle of 36 x 36

// one node's inputs in shared memory (floats; each part 16-byte aligned)
#define RB_Q 0
#define RB_R 1296
#define RB_M 2196
#define RB_QX 3276
#define RB_D 3312
#define RB_RU 3348
#define RIC_BUF 3380

#define PS 37   // row stride of P: a column read by 32 lanes hits 32 banks

// one problem's GN blocks and gains (node 0's; node n is n blocks further)
struct RicProblem {
  const float *Q, *R, *M, *qx, *ru, *d;
  float* G;
};

// a block's working set for the backward sweep (49,280 bytes, dynamic
// shared memory)
struct RicSmem {
  float in[2][RIC_BUF];        // node inputs, double-buffered by node parity
  float P[NX][PS];
  float pv[NX];
  float Pd[NX];                // P d + p
  float qxp[NX];
  float Wm[NU][NW];            // [Qux | qu], then W = L^{-1} [Qux | qu]
  alignas(16) float Lf[NU][32];      // Lf[k][m] = L[k+1+m][k]: column k below the diagonal
  alignas(16) float Lb[2][NU][32];   // Lb[i][m] = L[i][m+i-29]: row i right-aligned, by node parity
  alignas(16) float rs[2][32];       // 1 / L[k][k] by node parity
  float dg[2][32];                   // the factor warp's next diagonal, by pivot parity
};

// Compiled with -DRIC_TRACE (scripts/time_riccati_torch.py --trace), the
// sweep's threads 0, 32 and 96 (one of each role) write clock64() at their
// node's start and the ends of their phases, per (block, node), and thread
// 0 each block's clock64() and %globaltimer at four spans: the kernel's
// start (span 0, kernels 3 and 4), the sweep's start and end (1, 2) and the
// rollout's end (3, kernel 3); the shipped build has no stamps.
#ifdef RIC_TRACE
#define RIC_STAMPS 15
#define RIC_STAMP_CAP (1 << 19)
__device__ long long ric_stamps[RIC_STAMP_CAP];
__device__ long long ric_spans[4096 * 8];
// taken by whole warps (the __syncwarp keeps the clock read in its place)
#define RIC_STAMP(cond, n, i)                                                           \
  do {                                                                                  \
    __syncwarp();                                                                       \
    const long long c_ = clock64();                                                     \
    const size_t at_ = ((size_t)blockIdx.x * N + (n)) * RIC_STAMPS + (i);               \
    if ((cond) && at_ < RIC_STAMP_CAP) ric_stamps[at_] = c_;                            \
  } while (0)
#define RIC_SPAN(i)                                                                     \
  do {                                                                                  \
    if (threadIdx.x == 0 && blockIdx.x < 4096) {                                        \
      unsigned long long g_;                                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                           \
      ric_spans[blockIdx.x * 8 + 2 * (i)] = clock64();                                  \
      ric_spans[blockIdx.x * 8 + 2 * (i) + 1] = (long long)g_;                          \
    }                                                                                   \
  } while (0)
#else
#define RIC_STAMP(cond, n, i) \
  do {                        \
  } while (0)
#define RIC_SPAN(i) \
  do {              \
  } while (0)
#endif

// ---- asynchronous copies ----
__device__ __forceinline__ void ric_cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void ric_cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void ric_cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// warps 1-2 only
__device__ __forceinline__ void ric_columns_sync() { asm volatile("bar.sync 1, 64;\n" ::: "memory"); }


// Node n's inputs into s.in[n & 1] by cp.async, issued by warps 1-5 (the
// factor warp is on the critical path). The sources are 16-byte aligned
// (riccati_*_launch checks), ru (30 floats a node) by 4-byte copies.
__device__ __forceinline__ void ric_prefetch(const RicProblem& g, int n, RicSmem& s, int tid) {
  if (tid < RIC_COL0) return;
  const int t = tid - RIC_COL0, nt = RIC_THREADS - RIC_COL0;
  float* buf = s.in[n & 1];
  const float* Q = g.Q + (size_t)n * NX * NX;
  const float* R = g.R + (size_t)n * NU * NU;
  const float* M = g.M + (size_t)n * NX * NU;
  for (int q = t; q < NX * NX / 4; q += nt) ric_cp16(buf + RB_Q + 4 * q, Q + 4 * q);
  for (int q = t; q < NU * NU / 4; q += nt) ric_cp16(buf + RB_R + 4 * q, R + 4 * q);
  for (int q = t; q < NX * NU / 4; q += nt) ric_cp16(buf + RB_M + 4 * q, M + 4 * q);
  if (t < NX / 4) {
    ric_cp16(buf + RB_QX + 4 * t, g.qx + (size_t)n * NX + 4 * t);
    ric_cp16(buf + RB_D + 4 * t, g.d + (size_t)n * NX + 4 * t);
  } else if (t >= 32 && t < 32 + NU) {
    ric_cp4(buf + RB_RU + t - 32, g.ru + (size_t)n * NU + t - 32);
  }
}

// Terminal Gram: P = diag(tw^2) + reg I + sum_f s_f^2 Jz_f^T Jz_f, p likewise;
// Jz (4 x 18) by one tangent direction per thread of the first 18.
// Needs Cs loaded and visible (a __syncthreads after loading it).
__device__ inline void ric_terminal_gram(const float* Cs, const float* xN, const float* xref,
                                         const float* peak, float sh, const float* tw,
                                         float reg, float (*Jz)[18], float* pz, RicSmem& s,
                                         int tid, int nt) {
  if (tid < 18) {
    Dual q[18], pf[12];
    for (int i = 0; i < 18; ++i) q[i] = Dual(xN[i], i == tid ? 1.f : 0.f);
    feet_positions<Dual>(Cs, q, pf);
    for (int f = 0; f < 4; ++f) {
      Jz[f][tid] = pf[3 * f + 2].t;
      if (tid == 0) pz[f] = pf[3 * f + 2].v;
    }
  }
  __syncthreads();
  float s2[4];
  for (int f = 0; f < 4; ++f) {
    const float sc = peak[f] * tw[NX + f];
    s2[f] = sc * sc;
  }
  for (int e = tid; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float val = (i == j) ? tw[i] + reg : 0.f;
    if (i < 18 && j < 18)
      for (int f = 0; f < 4; ++f) val += s2[f] * Jz[f][i] * Jz[f][j];
    s.P[i][j] = val;
  }
  for (int i = tid; i < NX; i += nt) {
    float val = tw[i] * (xN[i] - xref[i]);
    if (i < 18)
      for (int f = 0; f < 4; ++f) val += s2[f] * (pz[f] - sh) * Jz[f][i];
    s.pv[i] = val;
  }
  __syncthreads();
}

// ---- the node stage, by role ----

// (A^T P A)[i][j] = i < 18 ? (P A)[i][j] : h (P A)[i-18][j] + (P A)[i][j],
// (P A)[r][c] = c < 18 ? P[r][c] : h P[r][c-18] + P[r][c], without branches
// (a warp's tiles sit in different quadrants): a zero coefficient adds an
// exact 0 where a term is absent.
__device__ __forceinline__ float ric_atpa(const float (*P)[PS], int i, int j, float h) {
  const int i0 = i < 18 ? i : i - 18, j0 = j < 18 ? j : j - 18;
  const float hi = i < 18 ? 0.f : h, hj = j < 18 ? 0.f : h;
  return fmaf(hi, fmaf(hj, P[i0][j0], P[i0][j]), fmaf(hj, P[i][j0], P[i][j]));
}

// Factor warp: lane i < 30's row of Quu = R + lm I + B^T P B (acceleration
// block: (B^T P B)[i][j] = hh PB_a[i][j] + h PB_a[18+i][j],
// PB_a[r][c] = hh P[r][c] + h P[r][18+c]); lanes 30, 31 hold zeros. No
// branch: a lane past the acceleration rows reads row 0 and weighs it by 0,
// so the loads of all 30 entries are issued together.
__device__ __forceinline__ void ric_quu_row(const float* R, const float (*P)[PS], float h,
                                            float lm, int i, float (&a)[NU]) {
  const float hh = 0.5f * h * h;
  const int il = i < NU ? i : 0, ia = i < 18 ? i : 0;
  const float ma = i < 18 ? 1.f : 0.f, mz = i < NU ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float val = R[il * NU + j] + (i == j ? lm : 0.f);
    if (j < 18) {
      const float pb_i = hh * P[ia][j] + h * P[ia][18 + j];
      const float pb_vi = hh * P[18 + ia][j] + h * P[18 + ia][18 + j];
      val = fmaf(ma, hh * pb_i + h * pb_vi, val);
    }
    a[j] = mz * val;
  }
}

// Factor warp, pivot k of Quu = L L^T: lane i holds row i's columns
// k .. 29 in a[0 .. 29 - k] (the row moves one register left a pivot, so
// every register index is static in a loop over k). r = rsqrt(max(d, 1e-30))
// from the diagonal d (the TPU kernel's pivot floor); lane i's L[i][k] goes
// to Lf[k][(i - k - 1) mod 32], column k below the diagonal at its head (all
// 32 lanes write: a permutation, the tail junk), and to Lb[i][k + 29 - i],
// row i right-aligned; lane k+1's next diagonal (the same fmaf as in the
// trailing update) to dg; after a __syncwarp every lane reads them back,
// the column as broadcast float4s (one store and J/4 loads a pivot where
// shuffles take J), and updates a[j] -= L[i][k] L[k+1+j][k] for J >= 29 - k
// columns (the columns past 29 and lanes 30, 31 carry junk never read).
template <int J>
__device__ __forceinline__ void ric_pivot(float (&a)[NU], int lane, int k, float& d, float& myr,
                                          float (*Lf)[32], float (*Lb)[32], float (*dg)[32]) {
  const float r = rsqrtf(fmaxf(d, 1e-30f));
  if (lane == k) myr = r;
  const float lk = a[0] * r;
  Lf[k][(lane - k - 1) & 31] = lk;
  if (lane > k && lane < NU) Lb[lane][k + NU - 1 - lane] = lk;
  dg[k & 1][lane] = fmaf(-lk, lk, a[1]);
  __syncwarp();
  d = dg[k & 1][(k + 1) & 31];
#pragma unroll
  for (int q = 0; q < (J + 3) / 4; ++q) {
    const float4 l = *reinterpret_cast<const float4*>(&Lf[k][4 * q]);
    const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < J) a[4 * q + m] = fmaf(-lk, lq[m], a[4 * q + m < J ? 4 * q + m + 1 : 0]);
  }
}

// Factor warp: Quu = L L^T from lane i's row i of Quu in a[] (lanes 30, 31
// zeros), no block barrier; writes L (Lf, Lb) and rs[i] = 1 / L[i][i].
__device__ __forceinline__ void ric_factor(float (&a)[NU], int lane, float (*Lf)[32],
                                           float (*Lb)[32], float* rs, float (*dg)[32]) {
  float myr = 0.f;
  float d = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll 2
  for (int k = 0; k < 10; ++k) ric_pivot<NU - 1>(a, lane, k, d, myr, Lf, Lb, dg);
#pragma unroll 2
  for (int k = 10; k < 20; ++k) ric_pivot<NU - 11>(a, lane, k, d, myr, Lf, Lb, dg);
#pragma unroll 2
  for (int k = 20; k < NU; ++k) ric_pivot<NU - 21>(a, lane, k, d, myr, Lf, Lb, dg);
  if (lane < NU) rs[lane] = myr;
}

// Forward solve, step k for J >= 29 - k rows: b[0 .. 29 - k] hold rows
// k .. 29 of the column; w_k = b[0] r_k to Wm, the rest updated by column k
// of L and moved one register left.
template <int J>
__device__ __forceinline__ void ric_fwd_step(float (&b)[NU], int k, int c, float (*Wm)[NW],
                                             const float (*Lf)[32], const float* rs) {
  const float wk = b[0] * rs[k];
  Wm[k][c] = wk;
#pragma unroll
  for (int q = 0; q < (J + 3) / 4; ++q) {
    const float4 l = *reinterpret_cast<const float4*>(&Lf[k][4 * q]);
    const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < J) b[4 * q + m] = fmaf(-lq[m], wk, b[4 * q + m < J ? 4 * q + m + 1 : 0]);
  }
}

// Column thread c < 37: column c of W = L^{-1} [Qux | qu] (Wm's column c in
// place), then back in b[] for the backward solve.
__device__ __forceinline__ void ric_forward(float (&b)[NU], int c, float (*Wm)[NW],
                                            const float (*Lf)[32], const float* rs) {
#pragma unroll
  for (int k = 0; k < NU; ++k) b[k] = Wm[k][c];
#pragma unroll 5
  for (int k = 0; k < 10; ++k) ric_fwd_step<NU - 1>(b, k, c, Wm, Lf, rs);
#pragma unroll 5
  for (int k = 10; k < 20; ++k) ric_fwd_step<NU - 11>(b, k, c, Wm, Lf, rs);
#pragma unroll 5
  for (int k = 20; k < NU; ++k) ric_fwd_step<NU - 21>(b, k, c, Wm, Lf, rs);
#pragma unroll
  for (int k = 0; k < NU; ++k) b[k] = Wm[k][c];
}

// Backward solve, step k (descending) for J >= k rows: b[29 - k .. 29] hold
// rows 0 .. k; z_k = b[29] r_k to the gains, the rest updated by row k of L
// and moved one register right.
template <int J>
__device__ __forceinline__ void ric_bwd_step(float (&b)[NU], int k, int c, const float (*Lb)[32],
                                             const float* rs, float* G) {
  const float zk = b[NU - 1] * rs[k];
  G[k * NW + c] = -zk;
#pragma unroll
  for (int q = 7; q >= (NU - 1 - J) / 4; --q) {
    const float4 l = *reinterpret_cast<const float4*>(&Lb[k][4 * q]);
    const float lq[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int m = 3; m >= 0; --m) {
      const int i = 4 * q + m;
      if (i >= NU - 1 - J && i <= NU - 2)
        b[i <= NU - 2 ? i + 1 : 0] = fmaf(-lq[m], zk, b[i <= NU - 2 ? i : 0]);
    }
  }
}

// Column thread c < 37: Z = L^{-T} W from W's column c in b[]; G[k][c] = -Z[k][c].
__device__ __forceinline__ void ric_backward(float (&b)[NU], int c, const float (*Lb)[32],
                                             const float* rs, float* G) {
#pragma unroll 5
  for (int k = NU - 1; k >= 20; --k) ric_bwd_step<NU - 1>(b, k, c, Lb, rs, G);
#pragma unroll 5
  for (int k = 19; k >= 10; --k) ric_bwd_step<NU - 11>(b, k, c, Lb, rs, G);
#pragma unroll 5
  for (int k = 9; k >= 0; --k) ric_bwd_step<NU - 21>(b, k, c, Lb, rs, G);
}

// Tile thread: (ti, tj), ti >= tj, of tile t < 78.
__device__ __forceinline__ void ric_tile_of(int t, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  tj = t - ti * (ti + 1) / 2;
}

// Tile thread: its tile of Qxx = Q + A^T P A, symmetrized, from the node's
// Q (row-major in shared memory) and P, into q[3 a + b].
__device__ __forceinline__ void ric_qxx_tile(const float* Q, const float (*P)[PS], float h,
                                             int ti, int tj, float (&q)[NU]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int i = 3 * ti + a, j = 3 * tj + b;
      q[3 * a + b] = 0.5f * ((Q[i * NX + j] + ric_atpa(P, i, j, h)) +
                             (Q[j * NX + i] + ric_atpa(P, j, i, h)));
    }
}

// Tile threads t < 96: Qux = M^T + B^T P A into Wm[:, :36] (M row-major
// (36, 30) in shared memory); an entry of the force rows (i >= 18) reads row
// 0 of P and weighs it by 0, so the loop has no branch.
__device__ __forceinline__ void ric_qux(const float* M, const float (*P)[PS], float h, int t,
                                        float (*Wm)[NW]) {
  const float hh = 0.5f * h * h;
#pragma unroll 4
  for (int e = t; e < NU * NX; e += RIC_THREADS - RIC_TILE0) {
    const int j = e / NU, i = e - j * NU;
    const int ia = i < 18 ? i : 0, j0 = j < 18 ? j : j - 18;
    const float hj = j < 18 ? 0.f : h;
    const float pa_a = fmaf(hj, P[ia][j0], P[ia][j]), pa_v = fmaf(hj, P[18 + ia][j0], P[18 + ia][j]);
    Wm[i][j] = fmaf(i < 18 ? 1.f : 0.f, hh * pa_a + h * pa_v, M[j * NU + i]);
  }
}

// Tile thread t < 78: its tile of P <- Qxx - W_x^T W_x. lo[3 a + b] holds
// Qxx[i][j] and up[3 a + b] Qxx[j][i] (i = 3 ti + a, j = 3 tj + b); the
// sweep's Qxx is symmetric and passes one array as both.
__device__ __forceinline__ void ric_value_tile(const float (&lo)[NU], const float (&up)[NU],
                                               int ti, int tj, const float (*Wm)[NW],
                                               float (*P)[PS]) {
  float acc[3][3] = {};
#pragma unroll 6
  for (int k = 0; k < NU; ++k) {
    float x[3], y[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = Wm[k][3 * ti + a];
      y[a] = Wm[k][3 * tj + a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int i = 3 * ti + a, j = 3 * tj + b;
      P[i][j] = lo[3 * a + b] - acc[a][b];
      P[j][i] = up[3 * a + b] - acc[a][b];
    }
}

// Column thread c < 36: p[c] <- qxp[c] - W_x[:, c]^T w_f.
__device__ __forceinline__ void ric_value_p(int c, const float (*Wm)[NW], const float* qxp,
                                            float* pv) {
  float acc = 0.f;
#pragma unroll 6
  for (int k = 0; k < NU; ++k) acc = fmaf(Wm[k][c], Wm[k][NX], acc);
  pv[c] = qxp[c] - acc;
}

// The backward sweep of one problem over its N nodes, by a block of
// RIC_THREADS threads. Expects ric_prefetch(g, N - 1) issued by every
// thread and (P_N, p_N) in s.P, s.pv, visible to every thread. Writes the
// gains [K | kff] of node n to g.G + n * NU * NW (row-major 30 x 37) and
// ends with a __syncthreads, so the gains are visible to the block.
__device__ inline void ric_sweep(const RicProblem& g, int N, float h, float lm, RicSmem& s,
                                 int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int c = tid - RIC_COL0, t = tid - RIC_TILE0;
  const float hh = 0.5f * h * h;
  int ti = 0, tj = 0;
  if (warp >= 3 && t < RIC_TILES) ric_tile_of(t, ti, tj);
  // one register array, by role (so the roles' arrays share registers):
  // warp 0 its row of Quu, then of L (phase 1); warps 1-2 column c of W
  // from the forward solve to the backward one (the next node's phase 1);
  // warps 3-5 the tile of Qxx, v[3 a + b], from phase 1 to the value update
  float v[NU];
  ric_cp_wait();
  __syncthreads();
  RIC_SPAN(1);
  for (int n = N - 1; n >= 0; --n) {
    const float* in = s.in[n & 1];
    RIC_STAMP(tid == 0 || tid == 32 || tid == 96, n, tid == 0 ? 0 : tid == 32 ? 5 : 10);
    if (n > 0) ric_prefetch(g, n - 1, s, tid);
    if (warp == 0) {
      ric_quu_row(in + RB_R, s.P, h, lm, lane, v);
      RIC_STAMP(lane == 0, n, 1);
      ric_factor(v, lane, s.Lf, s.Lb[n & 1], s.rs[n & 1], s.dg);
      RIC_STAMP(lane == 0, n, 2);
    } else if (warp < 3) {
      if (n < N - 1 && c < NW)
        ric_backward(v, c, s.Lb[(n + 1) & 1], s.rs[(n + 1) & 1], g.G + (size_t)(n + 1) * NU * NW);
      RIC_STAMP(c == 0, n, 6);
      const float* d = in + RB_D;
      if (c < NX) {
        float acc = s.pv[c];
#pragma unroll 6
        for (int j = 0; j < NX; ++j) acc += s.P[c][j] * d[j];
        s.Pd[c] = acc;
      }
      ric_columns_sync();
      if (c < NU) s.Wm[c][NX] = in[RB_RU + c] + (c < 18 ? hh * s.Pd[c] + h * s.Pd[18 + c] : 0.f);
      if (c < NX) s.qxp[c] = in[RB_QX + c] + (c < 18 ? s.Pd[c] : h * s.Pd[c - 18] + s.Pd[c]);
      RIC_STAMP(c == 0, n, 7);
    } else {
      if (t < RIC_TILES) ric_qxx_tile(in + RB_Q, s.P, h, ti, tj, v);
      ric_qux(in + RB_M, s.P, h, t, s.Wm);
      RIC_STAMP(t == 0, n, 11);
    }
    __syncthreads();
    RIC_STAMP(tid == 0 || tid == 32, n, tid == 0 ? 3 : 8);
    if (warp >= 1 && warp < 3) {
      if (c < NW) ric_forward(v, c, s.Wm, s.Lf, s.rs[n & 1]);
      RIC_STAMP(c == 0, n, 9);
    }
    __syncthreads();
    RIC_STAMP(tid == 0 || tid == 96, n, tid == 0 ? 4 : 12);
    if (warp >= 3) {
      if (n > 0 && t < RIC_TILES) ric_value_tile(v, v, ti, tj, s.Wm, s.P);
      RIC_STAMP(t == 0, n, 13);
    } else if (warp >= 1 && n > 0 && c < NX) {
      ric_value_p(c, s.Wm, s.qxp, s.pv);
    }
    ric_cp_wait();
    RIC_STAMP(t == 0, n, 14);
    __syncthreads();
  }
  if (N > 0 && warp >= 1 && warp < 3 && c < NW) ric_backward(v, c, s.Lb[0], s.rs[0], g.G);
  __syncthreads();
  RIC_SPAN(2);
}

// ---- the alpha = 1 rollout ----
//
// Replaces the TPU kernel's _forward_kernel (ops/riccati_kernel.py:650).
// Its bound on this card is bytes: 4,440 B of gains [K | kff] and 144 B of
// defects a node, read once, against ~36 dependent FMAs a node. Only
// dx -> du -> dx' is serial, and the gains do not depend on it, so one warp
// a problem streams node n+1 .. n+S-1's gains and defects into a ring of
// S = ROLL_STAGES stages of shared memory (cp.async.bulk, one mbarrier a
// stage) while node n runs; the chain itself stays on the chip. S = 8: at
// B=256, 7 nodes in flight a problem are 8.2 MB across the card, over the
// ~3.4 MB (3.35 TB/s x ~1 us of latency under load) that keep the memory
// busy, and 37 KB a problem leave six blocks an SM. S = 2 and 4 were
// slower at B = 256 and 512 (PERF.md, kernel 5's row).
#define ROLL_STAGES 8
static_assert((ROLL_STAGES & (ROLL_STAGES - 1)) == 0 && ROLL_STAGES >= 2,
              "ROLL_STAGES: a power of 2, at least 2");
#define ROLL_GWIN 1112                  // floats of a node's gains window (278 x 16 B)
#define ROLL_STAGE (ROLL_GWIN + NX)     // + the node's defects: 4,592 B a stage

// one warp's rollout workspace (37,088 B at S = 8)
struct RollSmem {
  alignas(16) float ring[ROLL_STAGES][ROLL_STAGE];
  alignas(16) float x[2][NX];           // dx by node parity
  unsigned long long bar[ROLL_STAGES];  // stage s's fills complete on bar[s]
};

__device__ __forceinline__ unsigned ric_su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// orders this thread's earlier generic-proxy accesses (shared and global)
// before later async-proxy ones (bulk copies)
__device__ __forceinline__ void ric_fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void ric_mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(ric_su32(bar)) : "memory");
}
__device__ __forceinline__ void ric_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void ric_mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(ric_su32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void ric_mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(ric_su32(bar)), "r"(parity)
        : "memory");
  }
}
// global -> shared, completing on bar (16-byte aligned, bytes a multiple of 16)
__device__ __forceinline__ void ric_bulk(float* dst, const float* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(ric_su32(dst)),
      "l"(src), "r"(bytes), "r"(ric_su32(bar))
      : "memory");
}

// Node m's gains and defects into ring stage m mod S (one thread). The
// gains tensor is 16-byte aligned and a node 4,440 = 8 mod 16 bytes, so a
// node starts at 0 or 8 mod 16: the window is the node widened to 16-byte
// bounds, 278 chunks from the chunk its start lies in (the gains then sit
// at float 0 or 2 of the stage). For a node that starts aligned the window
// ends 8 bytes past it, in the next node; for the tensor's last node that
// would read past the tensor, so its window is 277 chunks and its last 8
// bytes come by a plain load (L2: kernel 3 wrote them in this launch).
__device__ __forceinline__ void ric_roll_fetch(RollSmem& s, const float* G, const float* d,
                                               const float* gend, int m) {
  const int st = m & (ROLL_STAGES - 1);
  const float* win = reinterpret_cast<const float*>(
      reinterpret_cast<uintptr_t>(G + (size_t)m * NU * NW) & ~(uintptr_t)15);
  const bool last = win + ROLL_GWIN > gend;
  const unsigned gbytes = last ? 4 * ROLL_GWIN - 16 : 4 * ROLL_GWIN;
  ric_mbar_expect_tx(&s.bar[st], gbytes + 4 * NX);
  ric_bulk(s.ring[st], win, gbytes, &s.bar[st]);
  ric_bulk(s.ring[st] + ROLL_GWIN, d + (size_t)m * NX, 4 * NX, &s.bar[st]);
  if (last)
    *reinterpret_cast<float2*>(&s.ring[st][ROLL_GWIN - 4]) =
        __ldcg(reinterpret_cast<const float2*>(win + ROLL_GWIN - 4));
}

// alpha = 1 affine rollout of one problem by one warp (lane 0 .. 31) over
// its gains G (N x 30 x 37), defects d (N x 36) and dx0 (36) -> dX
// ((N+1) x 36), dU (N x 30); gend is the end of the whole gains tensor, G
// and d 16-byte aligned. Lane a < 30 owns row a of the gains in the ring
// (stride 37, odd: conflict-free) and forms du[a] = kff[a], then the FMAs
// over c = 0 .. 35 in ascending order, dx[c] a broadcast; lane i owns
// dx'[i] (lane i < 4 also dx'[32 + i]), its du[i mod 18] by a shuffle.
// dx' goes to shared memory by node parity: one __syncwarp a node. Lane 0
// keeps S - 1 nodes in flight.
__device__ inline void ric_rollout(const float* G, const float* d, const float* gend,
                                   const float* dx0, float* dX, float* dU, RollSmem& s, int N,
                                   float h, int lane) {
  const float hh = 0.5f * h * h;
  const int a = lane < NU ? lane : NU - 1;      // lanes 30, 31 repeat row 29, unstored
  const int i1 = 32 + (lane & 3);               // the second entry of lanes 0 .. 3
  const int j0 = lane < 18 ? lane : lane - 18;  // du's index in dx'[lane]
  const int v0 = lane < 18 ? lane + 18 : lane;  // dx'[lane < 18] reads dx[lane + 18]
  const float c0 = lane < 18 ? hh : h;
  if (lane == 0) {
    for (int k = 0; k < ROLL_STAGES; ++k) ric_mbar_init(&s.bar[k]);
    ric_mbar_init_fence();
    for (int m = 0; m < ROLL_STAGES - 1 && m < N; ++m) ric_roll_fetch(s, G, d, gend, m);
  }
  const float y0 = dx0[lane];
  s.x[0][lane] = y0;
  dX[lane] = y0;
  if (lane < 4) {
    const float y1 = dx0[i1];
    s.x[0][i1] = y1;
    dX[i1] = y1;
  }
  __syncwarp();
  for (int n = 0; n < N; ++n) {
    const int st = n & (ROLL_STAGES - 1);
    if (lane == 0 && n + ROLL_STAGES - 1 < N) ric_roll_fetch(s, G, d, gend, n + ROLL_STAGES - 1);
    const float* xs = s.x[n & 1];
    float x[NX];
#pragma unroll
    for (int q = 0; q < NX / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(&xs[4 * q]);
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
    const float xv = xs[v0], t1 = xs[i1];
    const float t0 = lane < 18 ? fmaf(h, xv, xs[lane]) : xs[lane];
    ric_mbar_wait(&s.bar[st], (unsigned)(n / ROLL_STAGES) & 1u);
    const float* ring = s.ring[st];
    const float* g = ring + ((reinterpret_cast<uintptr_t>(G + (size_t)n * NU * NW) >> 2) & 3) +
                     a * NW;
    float du = g[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) du = fmaf(g[c], x[c], du);
    const float d0 = ring[ROLL_GWIN + lane], d1 = ring[ROLL_GWIN + i1];
    if (lane < NU) dU[(size_t)n * NU + lane] = du;
    const float u0 = __shfl_sync(0xffffffffu, du, j0);
    const float u1 = __shfl_sync(0xffffffffu, du, i1 - 18);
    float* xn = s.x[(n + 1) & 1];
    float* dXn = dX + (size_t)(n + 1) * NX;
    const float y0n = fmaf(c0, u0, t0) + d0;
    xn[lane] = y0n;
    dXn[lane] = y0n;
    if (lane < 4) {
      const float y1n = fmaf(h, u1, t1) + d1;
      xn[i1] = y1n;
      dXn[i1] = y1n;
    }
    __syncwarp();
  }
}
