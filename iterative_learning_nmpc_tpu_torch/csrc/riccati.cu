// riccati_rollout: for each problem, build the terminal value function
// (P_N, p_N), run the structured Riccati backward sweep over the N nodes,
// then the alpha = 1 affine rollout -> dX (B, N+1, 36), dU (B, N, 30).
//
// Replaces iterative_learning_nmpc_tpu/ops/riccati_kernel.py:
// riccati_rollout_lane_major (_riccati_kernel with rollout=True, terminal
// Gram from _terminal_gram_init). Math: solver/sqp.py
// _riccati_solve_structured + _forward_delta_structured with the constant
// double-integrator A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]]:
// every product with A/B is a block scale-add.
//
// Bound on this card: the sequential dependence over nodes and, inside a
// node, over the 30 Cholesky pivots (latency, not bytes or flops: ~0.1
// MFLOP per node). Design: one block per problem, P (36x36) and the node's
// Q-function blocks in shared memory, the 30x30 Cholesky right-looking
// with a pivot floor rsqrt(max(d, 1e-30)) as in the TPU kernel, the
// triangular solves one thread per right-hand-side column, and the K-free
// value update P <- Qxx - W^T W with W = L^{-1} [Qux | qu]. The gains
// [K | kff] go to a global scratch tensor the wrapper allocates, and after
// a __syncthreads the same block runs the rollout over them, so every N
// takes the same path (no fused/split cutover).
#include "legdyn.cuh"

#define NX 36
#define NU 30
#define NW 37   // [Qux | qu] columns

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
  __shared__ float P[NX][NX];
  __shared__ float pv[NX];
  __shared__ float Pd[NX];
  __shared__ float Qxx[NX][NX];
  __shared__ float qxp[NX];
  __shared__ float L[NU][NU];
  __shared__ float Wm[NU][NW];
  __shared__ float rs[NU];
  __shared__ float Jz[4][18];
  __shared__ float pz[4];
  __shared__ float dx[NX];
  __shared__ float dxn[NX];
  __shared__ float du[NU];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float hh = 0.5f * h * h;
  for (int i = tid; i < N_CONSTS; i += nt) Cs[i] = consts[i];
  __syncthreads();

  // ---- terminal Gram: q-only dual FK, one tangent direction per thread ----
  const float* xN = xNg + (size_t)b * NX;
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
  {
    const float sh = shg[b];
    float s2[4];
    for (int f = 0; f < 4; ++f) {
      const float s = peakg[b * 4 + f] * tw[NX + f];
      s2[f] = s * s;
    }
    for (int e = tid; e < NX * NX; e += nt) {
      const int i = e / NX, j = e % NX;
      float val = (i == j) ? tw[i] + reg : 0.f;
      if (i < 18 && j < 18)
        for (int f = 0; f < 4; ++f) val += s2[f] * Jz[f][i] * Jz[f][j];
      P[i][j] = val;
    }
    for (int i = tid; i < NX; i += nt) {
      float val = tw[i] * (xN[i] - xrefg[(size_t)b * NX + i]);
      if (i < 18)
        for (int f = 0; f < 4; ++f) val += s2[f] * (pz[f] - sh) * Jz[f][i];
      pv[i] = val;
    }
  }
  __syncthreads();

  // ---- backward sweep ----
  for (int n = N - 1; n >= 0; --n) {
    const size_t bn = (size_t)b * N + n;
    const float* Q = Qg + bn * NX * NX;
    const float* R = Rg + bn * NU * NU;
    const float* M = Mg + bn * NX * NU;
    const float* d = dg + bn * NX;
    for (int i = tid; i < NX; i += nt) {
      float s = pv[i];
      for (int j = 0; j < NX; ++j) s += P[i][j] * d[j];
      Pd[i] = s;
    }
    __syncthreads();
    // Qxx = Q + A^T P A, symmetrized; PA'(i, j) = (P A)[i][j]
    for (int e = tid; e < NX * NX; e += nt) {
      const int i = e / NX, j = e % NX;
      auto PA = [&](int r, int c) { return c < 18 ? P[r][c] : h * P[r][c - 18] + P[r][c]; };
      const float aij = i < 18 ? PA(i, j) : h * PA(i - 18, j) + PA(i, j);
      const float aji = j < 18 ? PA(j, i) : h * PA(j - 18, i) + PA(j, i);
      Qxx[i][j] = 0.5f * ((Q[i * NX + j] + aij) + (Q[j * NX + i] + aji));
    }
    for (int i = tid; i < NX; i += nt)
      qxp[i] = qxg[bn * NX + i] + (i < 18 ? Pd[i] : h * Pd[i - 18] + Pd[i]);
    // Quu = R + lm I + B^T P B (acceleration block)
    for (int e = tid; e < NU * NU; e += nt) {
      const int i = e / NU, j = e % NU;
      float val = R[e] + (i == j ? lm : 0.f);
      if (i < 18 && j < 18) {
        // (B^T P B)[i][j] = hh * PB_a[i][j] + h * PB_a[18+i][j],
        // PB_a[r][c] = hh * P[r][c] + h * P[r][18+c]
        const float pb_i = hh * P[i][j] + h * P[i][18 + j];
        const float pb_vi = hh * P[18 + i][j] + h * P[18 + i][18 + j];
        val += hh * pb_i + h * pb_vi;
      }
      L[i][j] = val;
    }
    // [Qux | qu]: Qux = M^T + B^T P A, qu = ru + B^T (P d + p)
    for (int e = tid; e < NU * NW; e += nt) {
      const int i = e / NW, j = e % NW;
      float val;
      if (j < NX) {
        val = M[j * NU + i];
        if (i < 18) {
          auto PA = [&](int r, int c) { return c < 18 ? P[r][c] : h * P[r][c - 18] + P[r][c]; };
          val += hh * PA(i, j) + h * PA(18 + i, j);
        }
      } else {
        val = rug[bn * NU + i];
        if (i < 18) val += hh * Pd[i] + h * Pd[18 + i];
      }
      Wm[i][j] = val;
    }
    __syncthreads();

    // Cholesky Quu = L L^T in place (lower triangle), pivot floor 1e-30
    for (int k = 0; k < NU; ++k) {
      if (tid == 0) {
        const float dkk = L[k][k];
        const float r = rsqrtf(fmaxf(dkk, 1e-30f));
        rs[k] = r;
        L[k][k] = dkk * r;
      }
      __syncthreads();
      for (int i = k + 1 + tid; i < NU; i += nt) L[i][k] *= rs[k];
      __syncthreads();
      const int m = NU - k - 1;
      for (int e = tid; e < m * m; e += nt) {
        const int i = k + 1 + e / m, j = k + 1 + e % m;
        if (j <= i) L[i][j] -= L[i][k] * L[j][k];
      }
      __syncthreads();
    }

    // W = L^{-1} [Qux | qu] in place, then Z = L^{-T} W: [K | kff] = -Z
    float* G = gains + bn * NU * NW;
    if (tid < NW) {
      const int c = tid;
      for (int k = 0; k < NU; ++k) {
        float s = Wm[k][c];
        for (int j = 0; j < k; ++j) s -= L[k][j] * Wm[j][c];
        Wm[k][c] = s * rs[k];
      }
      float z[NU];
      for (int k = NU - 1; k >= 0; --k) {
        float s = Wm[k][c];
        for (int j = k + 1; j < NU; ++j) s -= L[j][k] * z[j];
        z[k] = s * rs[k];
      }
      for (int k = 0; k < NU; ++k) G[k * NW + c] = -z[k];
    }
    __syncthreads();

    // value update: P <- Qxx - W_x^T W_x, p <- qxp - W_x^T w_f
    for (int e = tid; e < NX * NX; e += nt) {
      const int i = e / NX, j = e % NX;
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      float s = 0.f;
      for (int k = 0; k < NU; ++k) s += Wm[k][lo] * Wm[k][hi];
      P[i][j] = Qxx[i][j] - s;
    }
    for (int i = tid; i < NX; i += nt) {
      float s = 0.f;
      for (int k = 0; k < NU; ++k) s += Wm[k][i] * Wm[k][NX];
      pv[i] = qxp[i] - s;
    }
    __syncthreads();
  }

  // ---- alpha = 1 affine rollout over the gains ----
  for (int i = tid; i < NX; i += nt) dx[i] = dx0g[(size_t)b * NX + i];
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    const size_t bn = (size_t)b * N + n;
    const float* G = gains + bn * NU * NW;
    for (int a = tid; a < NU; a += nt) {
      float s = G[a * NW + NX];
      for (int c = 0; c < NX; ++c) s += G[a * NW + c] * dx[c];
      du[a] = s;
      dUg[bn * NU + a] = s;
    }
    for (int i = tid; i < NX; i += nt) dXg[((size_t)b * (N + 1) + n) * NX + i] = dx[i];
    __syncthreads();
    const float* d = dg + bn * NX;
    for (int i = tid; i < NX; i += nt)
      dxn[i] = i < 18 ? dx[i] + h * dx[18 + i] + hh * du[i] + d[i]
                      : dx[i] + h * du[i - 18] + d[i];
    __syncthreads();
    for (int i = tid; i < NX; i += nt) dx[i] = dxn[i];
    __syncthreads();
  }
  for (int i = tid; i < NX; i += nt) dXg[((size_t)b * (N + 1) + N) * NX + i] = dx[i];
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
