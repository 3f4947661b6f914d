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
// Bound on this card: neither bytes nor operations. The bytes are small
// (66 floats in, 42 + 42 x 54 out an evaluation) and so are the operations
// (~1 Mflop an evaluation as the plain twin counts them); what an
// evaluation costs is the instructions its warps execute one after
// another: sin/cos pairs, 3x3 products and cross products in dual-number
// arithmetic, ~6.8 k a lane. At M = 25 one block an evaluation runs on 25
// of the 132 SMs and the launch takes as long as one block's chain.
//
// Design: a (direction, leg) pair per lane, DJ_THREADS = 96 lanes (three
// full warps) a block, one evaluation a block. A thread per direction
// through the whole body_pass<Dual> would repeat all four legs (and keep
// per-leg arrays in local memory) even for a joint direction that moves
// one leg, so the pass is cut where the legs meet the trunk (legdyn.cuh's
// trunk_state, leg_chain, trunk_wrench, on Dual):
// - lanes 0..59: 15 base directions (the attitude q 3..5, v 0..5, a
//   0..5), four consecutive lanes each, one per leg. Each lane seeds its
//   direction in the trunk's coordinates and runs its leg's three links;
//   the four legs' wrenches (values and tangents) are summed by two
//   __shfl_xor_sync steps, (l0 + l1) + (l2 + l3) in every lane, and the
//   trunk's Newton-Euler gives tau 0..5. Lanes 0..3 also carry the values.
// - lanes 60..95: the 36 joint directions (q, v, a of a leg's three
//   joints), one lane each: its own leg's chain only. The trunk's motion
//   has no tangent along them, so tau 0..5 takes that leg's wrench alone
//   (the lane keeps its own wrench where a base lane takes the sum).
// - the base position q 0..2 takes no lane: its columns are constants. A
//   translation moves every point and leaves every velocity, acceleration
//   and torque as it was (the trunk's moment is taken about the base
//   origin), so each foot point moves with it (identity) and every other
//   row stays (zero; exact in the plain twin too; computed, those rows
//   would be sums of terms that cancel to ~1e-6). Without these three
//   directions an evaluation fills three warps exactly (with them, 108
//   lanes in four): the kernel's time is its warps' instruction streams,
//   one block's at M=25 and all of them at M=12,800 (PERF.md).
// Every per-thread index is static (local memory must stay at 0 B:
// chip_smoke.py fails otherwise). The evaluation's 42 x 54 tile (9,072 B)
// is built in shared memory, filled with zeros first; each lane writes only
// its column's rows its direction can move, so the structural zeros
// (ops/dynjac.structural_zeros: foot points along v and a, foot velocities
// along a and the base position, a leg's rows along another leg's joints,
// and everything but the foot points along the base position) are stored
// as zeros; then the tile leaves as contiguous float4 rows (J comes from
// torch.empty). Accurate sinf/cosf and fp32 only; against the plain twin
// the four-leg sums' order is the difference.
#include "legdyn.cuh"

#define DJ_NDIR 54      // 36 state + 18 acceleration directions
#define DJ_NOUT 42
#define DJ_TILE (DJ_NOUT * DJ_NDIR)
#define DJ_BASE 60      // 15 base directions x 4 legs
#define DJ_THREADS 96   // and 36 joint directions

__global__ void __launch_bounds__(DJ_THREADS)
dynjac_kernel(const float* __restrict__ X, const float* __restrict__ A,
              const float* __restrict__ F, const float* __restrict__ consts,
              float* __restrict__ prim, float* __restrict__ J) {
  __shared__ float Cs[N_CONSTS];
  __shared__ float Zs[66];          // x 36 | a 18 | fe 12
  __shared__ float Ps[DJ_NOUT];
  __shared__ __align__(16) float Js[DJ_TILE];
  const size_t m = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < N_CONSTS; i += DJ_THREADS) Cs[i] = consts[i];
  if (t < 36) Zs[t] = X[m * 36 + t];
  else if (t < 54) Zs[t] = A[m * 18 + t - 36];
  else if (t < 66) Zs[t] = F[m * 12 + t - 54];
  float4* J4 = reinterpret_cast<float4*>(Js);
  for (int i = t; i < DJ_TILE / 4; i += DJ_THREADS) J4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the lane's direction: kind 0, 1, 2 (q, v, a); coord its base
  // coordinate 0..5 or its joint 0..11; the leg it runs; its column of J
  const bool base = t < DJ_BASE;
  const int d = (t >> 2) + 3;   // base direction: q 3..5, then v 0..5, a 0..5
  const int kind = base ? d / 6 : (t - DJ_BASE) / 12;
  const int coord = base ? d % 6 : (t - DJ_BASE) % 12;
  const int leg = base ? (t & 3) : coord / 3;
  const int col = 18 * kind + (base ? coord : 6 + coord);
  const float* x = Zs;
  const float* a = Zs + 36;

  Dual qb[6], vb[6], ab[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const bool on = base && coord == i;
    qb[i] = Dual(x[i], on && kind == 0 ? 1.f : 0.f);
    vb[i] = Dual(x[18 + i], on && kind == 1 ? 1.f : 0.f);
    ab[i] = Dual(a[i], on && kind == 2 ? 1.f : 0.f);
  }
  Trunk<Dual> b;
  trunk_state(qb, vb, ab, b);
  Dual q3[3], v3[3], a3[3], fe3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool on = !base && coord == 3 * leg + k;
    q3[k] = Dual(x[6 + 3 * leg + k], on && kind == 0 ? 1.f : 0.f);
    v3[k] = Dual(x[24 + 3 * leg + k], on && kind == 1 ? 1.f : 0.f);
    a3[k] = Dual(a[6 + 3 * leg + k], on && kind == 2 ? 1.f : 0.f);
    fe3[k] = Dual(Zs[54 + 3 * leg + k]);
  }
  Dual pf[3], vf[3], tau3[3], Fl[3], Ml[3], tau6[6];
  leg_chain(Cs, leg, b, q3, v3, a3, fe3, pf, vf, tau3, Fl, Ml);
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const Dual fo(__shfl_xor_sync(0xffffffffu, Fl[i].v, s),
                    __shfl_xor_sync(0xffffffffu, Fl[i].t, s));
      const Dual mo(__shfl_xor_sync(0xffffffffu, Ml[i].v, s),
                    __shfl_xor_sync(0xffffffffu, Ml[i].t, s));
      if (base) {
        Fl[i] = Fl[i] + fo;
        Ml[i] = Ml[i] + mo;
      }
    }
  trunk_wrench(Cs, b, Fl, Ml, tau6);

  float* Jc = Js + col;   // the lane's column: row r at Jc[r * DJ_NDIR]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (kind == 0) Jc[(3 * leg + i) * DJ_NDIR] = pf[i].t;
    if (kind < 2) Jc[(12 + 3 * leg + i) * DJ_NDIR] = vf[i].t;
    Jc[(30 + 3 * leg + i) * DJ_NDIR] = tau3[i].t;
  }
  // tau 0..5: a base group's lane l writes rows l and 4 + l, a joint lane all six
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (!base || (i & 3) == leg) Jc[(24 + i) * DJ_NDIR] = tau6[i].t;
  // the base position's columns: each foot point moves with it
  if (t < 12) Js[t * DJ_NDIR + t % 3] = 1.f;
  if (t < 4) {   // the first base direction's four lanes store the values
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Ps[3 * leg + i] = pf[i].v;
      Ps[12 + 3 * leg + i] = vf[i].v;
      Ps[30 + 3 * leg + i] = tau3[i].v;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if ((i & 3) == leg) Ps[24 + i] = tau6[i].v;
  }
  __syncthreads();
  float4* Jg = reinterpret_cast<float4*>(J + m * DJ_TILE);
  for (int i = t; i < DJ_TILE / 4; i += DJ_THREADS) Jg[i] = J4[i];
  if (t < DJ_NOUT) prim[m * DJ_NOUT + t] = Ps[t];
}

// J must be 16-byte aligned (the wrapper allocates it; 9,072 B a tile).
extern "C" int dynjac_launch(const float* X, const float* A, const float* F,
                             const float* consts, float* prim, float* J, int M,
                             void* stream) {
  dynjac_kernel<<<M, DJ_THREADS, 0, (cudaStream_t)stream>>>(X, A, F, consts, prim, J);
  return (int)cudaGetLastError();
}

// The compiled kernel's registers a thread, local bytes a thread (stack
// frame and spills) and resident blocks an SM: out[0..2].
extern "C" int dynjac_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dynjac_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)dynjac_kernel,
                                                      DJ_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
