// dynjac: FK + foot velocities + RNEA of M independent evaluations AND
// their exact Jacobian with respect to (x, a), the foot forces held fixed:
// prim (M, 42) = [p_feet 12 | v_feet 12 | tau 18], J (M, 42, 54) with
// columns x (36: q 18, v 18) then a (18).
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:dynjac_pallas
// (_dynjac_kernel). Its caller, solver/linearize.py lingram_structured, is
// the single-problem (B = 1) linearization of the closed-loop controller:
// M = N = 25 evaluations per solve.
//
// Bound on this card: arithmetic latency. Each column is one forward-mode
// pass through the whole FK/RNEA recursion (~3k value flops plus the
// tangent's ~6k), a long dependent scalar chain; the bytes are small (66
// floats in, 42 + 42*54 out per evaluation). Design: one block per
// evaluation; thread t < 54 pushes ONE width-1 tangent (direction t) through
// body_pass<Dual> of legdyn.cuh and writes column t of J, so a warp's
// stores of one row are contiguous; thread 0 also writes the values. The
// TPU kernel's 56-row tangent padding and 128-lane layout are not carried
// over. At M = 25 only 25 SMs work: the controller's call is latency-bound.
#include "legdyn.cuh"

#define DJ_NDIR 54      // 36 state + 18 acceleration directions
#define DJ_NOUT 42
#define DJ_THREADS 64   // two warps; threads 54..63 only stage inputs

__global__ void __launch_bounds__(DJ_THREADS)
dynjac_kernel(const float* __restrict__ X, const float* __restrict__ A,
              const float* __restrict__ F, const float* __restrict__ consts,
              float* __restrict__ prim, float* __restrict__ J) {
  __shared__ float Cs[N_CONSTS];
  __shared__ float Zs[66];          // x 36 | a 18 | fe 12
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < N_CONSTS; i += DJ_THREADS) Cs[i] = consts[i];
  if (t < 36) Zs[t] = X[(size_t)m * 36 + t];
  if (t < 18) Zs[36 + t] = A[(size_t)m * 18 + t];
  if (t < 12) Zs[54 + t] = F[(size_t)m * 12 + t];
  __syncthreads();
  if (t >= DJ_NDIR) return;

  Dual q[18], v[18], a[18], fe[12];
  for (int i = 0; i < 18; ++i) {
    q[i] = Dual(Zs[i], i == t ? 1.f : 0.f);
    v[i] = Dual(Zs[18 + i], 18 + i == t ? 1.f : 0.f);
    a[i] = Dual(Zs[36 + i], 36 + i == t ? 1.f : 0.f);
  }
  for (int i = 0; i < 12; ++i) fe[i] = Dual(Zs[54 + i], 0.f);
  Dual pf[12], vf[12], tau[18];
  body_pass<Dual>(Cs, q, v, a, fe, pf, vf, tau);

  float* Jm = J + (size_t)m * DJ_NOUT * DJ_NDIR + t;
  for (int i = 0; i < 12; ++i) {
    Jm[i * DJ_NDIR] = pf[i].t;
    Jm[(12 + i) * DJ_NDIR] = vf[i].t;
  }
  for (int i = 0; i < 18; ++i) Jm[(24 + i) * DJ_NDIR] = tau[i].t;
  if (t == 0) {
    float* o = prim + (size_t)m * DJ_NOUT;
    for (int i = 0; i < 12; ++i) {
      o[i] = pf[i].v;
      o[12 + i] = vf[i].v;
    }
    for (int i = 0; i < 18; ++i) o[24 + i] = tau[i].v;
  }
}

extern "C" int dynjac_launch(const float* X, const float* A, const float* F,
                             const float* consts, float* prim, float* J, int M,
                             void* stream) {
  dynjac_kernel<<<M, DJ_THREADS, 0, (cudaStream_t)stream>>>(X, A, F, consts, prim, J);
  return (int)cudaGetLastError();
}
