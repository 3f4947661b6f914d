// The three stages of the structured Riccati solve, as block-cooperative
// __device__ functions shared by the kernels of riccati.cu:
//
//   ric_terminal_gram  the terminal value function (P_N, p_N) from the
//                      q-only dual FK of the terminal state,
//   ric_node           one backward node: the Q-function blocks, the 30x30
//                      Cholesky, [K | kff] to global memory, P and p updated
//                      (its second half, ric_factor_solve, is the
//                      factorize-and-solve alone),
//   ric_rollout        the alpha = 1 affine rollout over [K | kff].
//
// Math: iterative_learning_nmpc_tpu/solver/sqp.py _riccati_solve_structured
// + _forward_delta_structured with the constant double-integrator
// A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]]: every product with A/B
// is a block scale-add. Each stage has one arithmetic order, whichever
// kernel runs it, so the fused kernel and the split chain agree bit for bit.
#pragma once
#include "legdyn.cuh"

#define NX 36
#define NU 30
#define NW 37   // [Qux | qu] columns; the gains are [K | kff] (NU x NW)

// a block's working set for the backward sweep (18.96 KB)
struct RicSmem {
  float P[NX][NX];
  float pv[NX];
  float Pd[NX];
  float Qxx[NX][NX];
  float qxp[NX];
  float L[NU][NU];
  float Wm[NU][NW];
  float rs[NU];
};

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};

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

// The node's factorize-and-solve, from the Q-function blocks in shared
// memory (s.L = Quu, s.Wm = [Qux | qu], s.Qxx, s.qxp, visible to every
// thread): Cholesky Quu = L L^T, W = L^{-1} [Qux | qu], Z = L^{-T} W;
// writes G = [K | kff] = -Z (30 x 37, row-major) and leaves
// P = Qxx - W_x^T W_x, p = qxp - W_x^T w_f in s.P, s.pv. The stage of
// ric_node after it forms the blocks; ops/probes.py times it alone.
__device__ inline void ric_factor_solve(RicSmem& s, float* G, int tid, int nt) {
  // Cholesky Quu = L L^T in place (lower triangle), pivot floor 1e-30
  for (int k = 0; k < NU; ++k) {
    if (tid == 0) {
      const float dkk = s.L[k][k];
      const float r = rsqrtf(fmaxf(dkk, 1e-30f));
      s.rs[k] = r;
      s.L[k][k] = dkk * r;
    }
    __syncthreads();
    for (int i = k + 1 + tid; i < NU; i += nt) s.L[i][k] *= s.rs[k];
    __syncthreads();
    const int m = NU - k - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) s.L[i][j] -= s.L[i][k] * s.L[j][k];
    }
    __syncthreads();
  }

  // W = L^{-1} [Qux | qu] in place, then Z = L^{-T} W: [K | kff] = -Z
  if (tid < NW) {
    const int c = tid;
    for (int k = 0; k < NU; ++k) {
      float v = s.Wm[k][c];
      for (int j = 0; j < k; ++j) v -= s.L[k][j] * s.Wm[j][c];
      s.Wm[k][c] = v * s.rs[k];
    }
    float z[NU];
    for (int k = NU - 1; k >= 0; --k) {
      float v = s.Wm[k][c];
      for (int j = k + 1; j < NU; ++j) v -= s.L[j][k] * z[j];
      z[k] = v * s.rs[k];
    }
    for (int k = 0; k < NU; ++k) G[k * NW + c] = -z[k];
  }
  __syncthreads();

  // value update: P <- Qxx - W_x^T W_x, p <- qxp - W_x^T w_f
  for (int e = tid; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    float v = 0.f;
    for (int k = 0; k < NU; ++k) v += s.Wm[k][lo] * s.Wm[k][hi];
    s.P[i][j] = s.Qxx[i][j] - v;
  }
  for (int i = tid; i < NX; i += nt) {
    float v = 0.f;
    for (int k = 0; k < NU; ++k) v += s.Wm[k][i] * s.Wm[k][NX];
    s.pv[i] = s.qxp[i] - v;
  }
  __syncthreads();
}

// One backward node from (s.P, s.pv): Q (36x36), R (30x30), M (36x30),
// qx (36), ru (30), d (36) of this node; writes G = [K | kff] (30 x 37,
// row-major) and leaves the node's (P, p) in s.P, s.pv.
__device__ inline void ric_node(const float* Q, const float* R, const float* M,
                                const float* qx, const float* ru, const float* d, float* G,
                                float h, float lm, RicSmem& s, int tid, int nt) {
  const float hh = 0.5f * h * h;
  for (int i = tid; i < NX; i += nt) {
    float v = s.pv[i];
    for (int j = 0; j < NX; ++j) v += s.P[i][j] * d[j];
    s.Pd[i] = v;
  }
  __syncthreads();
  // PA(r, c) = (P A)[r][c]
  auto PA = [&](int r, int c) { return c < 18 ? s.P[r][c] : h * s.P[r][c - 18] + s.P[r][c]; };
  // Qxx = Q + A^T P A, symmetrized
  for (int e = tid; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    const float aij = i < 18 ? PA(i, j) : h * PA(i - 18, j) + PA(i, j);
    const float aji = j < 18 ? PA(j, i) : h * PA(j - 18, i) + PA(j, i);
    s.Qxx[i][j] = 0.5f * ((Q[i * NX + j] + aij) + (Q[j * NX + i] + aji));
  }
  for (int i = tid; i < NX; i += nt)
    s.qxp[i] = qx[i] + (i < 18 ? s.Pd[i] : h * s.Pd[i - 18] + s.Pd[i]);
  // Quu = R + lm I + B^T P B (acceleration block)
  for (int e = tid; e < NU * NU; e += nt) {
    const int i = e / NU, j = e % NU;
    float val = R[e] + (i == j ? lm : 0.f);
    if (i < 18 && j < 18) {
      // (B^T P B)[i][j] = hh * PB_a[i][j] + h * PB_a[18+i][j],
      // PB_a[r][c] = hh * P[r][c] + h * P[r][18+c]
      const float pb_i = hh * s.P[i][j] + h * s.P[i][18 + j];
      const float pb_vi = hh * s.P[18 + i][j] + h * s.P[18 + i][18 + j];
      val += hh * pb_i + h * pb_vi;
    }
    s.L[i][j] = val;
  }
  // [Qux | qu]: Qux = M^T + B^T P A, qu = ru + B^T (P d + p)
  for (int e = tid; e < NU * NW; e += nt) {
    const int i = e / NW, j = e % NW;
    float val;
    if (j < NX) {
      val = M[j * NU + i];
      if (i < 18) val += hh * PA(i, j) + h * PA(18 + i, j);
    } else {
      val = ru[i];
      if (i < 18) val += hh * s.Pd[i] + h * s.Pd[18 + i];
    }
    s.Wm[i][j] = val;
  }
  __syncthreads();
  ric_factor_solve(s, G, tid, nt);
}

// alpha = 1 affine rollout of one problem over its gains G (N x 30 x 37),
// defects d (N x 36) and dx0 (36) -> dX ((N+1) x 36), dU (N x 30). Threads
// tid < nt of one group (a block or a warp, synchronized by `sync`) share
// the scratch rows dx, dxn (36) and du (30).
template <class Sync>
__device__ inline void ric_rollout(const float* G, const float* d, const float* dx0, float* dX,
                                   float* dU, float* dx, float* dxn, float* du, int N, float h,
                                   int tid, int nt, Sync sync) {
  const float hh = 0.5f * h * h;
  for (int i = tid; i < NX; i += nt) dx[i] = dx0[i];
  sync();
  for (int n = 0; n < N; ++n) {
    const float* Gn = G + (size_t)n * NU * NW;
    for (int a = tid; a < NU; a += nt) {
      float v = Gn[a * NW + NX];
      for (int c = 0; c < NX; ++c) v += Gn[a * NW + c] * dx[c];
      du[a] = v;
      dU[(size_t)n * NU + a] = v;
    }
    for (int i = tid; i < NX; i += nt) dX[(size_t)n * NX + i] = dx[i];
    sync();
    const float* dn = d + (size_t)n * NX;
    for (int i = tid; i < NX; i += nt)
      dxn[i] = i < 18 ? dx[i] + h * dx[18 + i] + hh * du[i] + dn[i]
                      : dx[i] + h * du[i - 18] + dn[i];
    sync();
    for (int i = tid; i < NX; i += nt) dx[i] = dxn[i];
    sync();
  }
  for (int i = tid; i < NX; i += nt) dX[(size_t)N * NX + i] = dx[i];
}
