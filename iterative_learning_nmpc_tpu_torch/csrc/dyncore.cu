// dyncore: value-only FK + foot velocities + RNEA for M independent
// evaluations, out (M, 42) = [p_feet 12 | v_feet 12 | tau 18].
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:dyncore_pallas
// (_dyncore_kernel). On the RTI path M = n_alpha * B * (N+1): 2 * 512 * 26 =
// 26,624 on the main path's chain, 2 * 256 * 101 at N=100, 2 * 256 * 26 in
// datagen, 52 (104 with four alphas) in the closed loop's B=1 replan.
//
// Bound on this card: neither bytes nor operations. At M = 26,624 the
// bytes (66 floats in, 42 out a row: 11.5 MB) take 3.4 us at 3.35 TB/s and
// the operations (~6.6 k flops a row by hand, ~10.9 k as the plain twin
// counts them) 2.6-4.3 us at 67 TFLOP/s. What limits it is issue and
// latency: each evaluation is a long dependent scalar chain through 15
// sin/cos pairs and 12 links, and the card needs enough such chains in
// flight to fill its issue slots. A thread per evaluation (the first port) gave ~6 warps
// an SM at M = 26,624 and one warp at M = 52, read its rows at strides of
// 144, 72 and 48 B, and kept its per-leg arrays in local memory (a rolled
// leg loop indexing them by the leg): 0.031 ms alone at M = 26,624 on an
// H100 SXM (700 W).
//
// Design: a leg per lane. Four consecutive lanes take one evaluation, so a
// warp holds 8 and a block of DC_THREADS = 256 threads DC_EVALS = 64. Lane
// l computes the trunk's frame, rates and accelerations itself (3 sin/cos
// pairs, ~100 flops, no barrier), runs leg l's three-link chain with its
// joint values in registers and every per-thread index static (leg_chain;
// 126 registers, no local memory, 2 blocks = 16 warps an SM), and gives
// foot l's point and velocity and joint torques 6+3l..8+3l. The legs'
// wrenches on the trunk are summed over the four lanes by two
// __shfl_xor_sync steps, (l0 + l1) + (l2 + l3) in every lane, bit for bit
// the same each run; the trunk's Newton-Euler and tau 0..5 follow in every
// lane, and lane 0 stores them. A block's rows of X, A, F are one
// contiguous span each: the block copies them into shared memory with
// neighbouring threads on neighbouring addresses (16-byte accesses when the
// span's start is 16-byte aligned, 4-byte ones otherwise: a view may start
// at any float), and its 64 x 42 output tile back out the same way. The
// robot constants (N_CONSTS floats) are staged once a block. Accurate
// sinf/cosf and fp32 FMAs only; against the plain twin the four-leg sums'
// order is the new difference. body_pass (legdyn.cuh) stays as the Dual
// callers (lingram, dynjac, the terminal Gram) have it: their register
// budgets and the split chain's bit-equality rest on it.
#include <stdint.h>

#include "legdyn.cuh"

// 256 threads a block, 64 evaluations; 2 blocks an SM fit without a
// register cap (126 registers); a tighter cap spills (PERF.md)
#define DC_THREADS 256
#define DC_EVALS (DC_THREADS / 4)
#define DC_OUT 42

// The trunk's pose, rates and accelerations (world frame) and T, the
// Euler-rate map, from an evaluation's base coordinates; gravity enters as
// a base acceleration.
struct Trunk {
  float R[3][3], T[3][3], p[3], v[3], w[3], dv[3], dw[3];
};

__device__ __forceinline__ void trunk_state(const float* q, const float* v, const float* a,
                                            Trunk& b) {
  const float cy = cosf(q[3]), sy = sinf(q[3]);
  const float cp = cosf(q[4]), sp = sinf(q[4]);
  const float cr = cosf(q[5]), sr = sinf(q[5]);
  ypr_matrix(cy, sy, cp, sp, cr, sr, b.R);
  const float T[3][3] = {{-sp, 0.f, 1.f}, {cp * sr, cr, 0.f}, {cp * cr, -sr, 0.f}};
  const float pd = v[4], rd = v[5];
  const float Td[3][3] = {{-cp * pd, 0.f, 0.f},
                          {-sp * pd * sr + cp * cr * rd, -sr * rd, 0.f},
                          {-sp * pd * cr - cp * sr * rd, -cr * rd, 0.f}};
  const float yd[3] = {v[3], v[4], v[5]};
  const float ydd[3] = {a[3], a[4], a[5]};
  float w_l[3], t1[3], t2[3], wl_dot[3];
  mv3(T, yd, w_l);
  mv3(b.R, w_l, b.w);
  mv3(Td, yd, t1);
  mv3(T, ydd, t2);
  add3(t1, t2, wl_dot);
  mv3(b.R, wl_dot, b.dw);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) b.T[i][j] = T[i][j];
    b.p[i] = q[i];
    b.v[i] = v[i];
    b.dv[i] = a[i];
  }
  b.dv[2] = a[2] + LEG_GRAVITY;
}

// Leg `leg`'s three links on the trunk b: q3, v3, a3 its joint angles,
// rates and accelerations, fe3 its world foot force. Gives its foot point
// and velocity, its three joint torques, and the wrench (F, M about the
// world origin) that its links and foot force put on the trunk. Per-thread
// arrays are indexed statically only; the constants in C by `leg`.
__device__ __forceinline__ void leg_chain(const float* C, int leg, const Trunk& b,
                                          const float q3[3], const float v3[3],
                                          const float a3[3], const float fe3[3],
                                          float p_foot[3], float v_foot[3], float tau3[3],
                                          float F[3], float M[3]) {
  float R_p[3][3], p_p[3], w_p[3], v_p[3], dw_p[3], dv_p[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R_p[i][j] = b.R[i][j];
    p_p[i] = b.p[i]; w_p[i] = b.w[i]; v_p[i] = b.v[i];
    dw_p[i] = b.dw[i]; dv_p[i] = b.dv[i];
  }
  float Fs[4][3], Ms[4][3], pjs[3][3], axs[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int idx = 3 * leg + k;
    const float* axis = C + C_AX + 3 * idx;
    float a_w[3], off[3], p_k[3], Rot[3][3], R_k[3][3];
    mvc3(R_p, axis, a_w);
    rodrigues(axis, cosf(q3[k]), sinf(q3[k]), Rot);
    mm3(R_p, Rot, R_k);
    mvc3(R_p, C + C_JP + 3 * idx, off);
    add3(p_p, off, p_k);
    float c1[3], c2[3], c3[3], v_k[3], dv_k[3], w_k[3], dw_k[3], awqd[3];
    cross3(w_p, off, c1);
    add3(v_p, c1, v_k);
    cross3(dw_p, off, c1);
    cross3(w_p, off, c2);
    cross3(w_p, c2, c3);
    for (int i = 0; i < 3; ++i) dv_k[i] = dv_p[i] + c1[i] + c3[i];
    for (int i = 0; i < 3; ++i) {
      awqd[i] = a_w[i] * v3[k];
      w_k[i] = w_p[i] + awqd[i];
    }
    cross3(w_p, awqd, c1);
    for (int i = 0; i < 3; ++i) dw_k[i] = dw_p[i] + a_w[i] * a3[k] + c1[i];
    // Newton-Euler about the link CoM, inertia products in the body frame
    float c_w[3], x_c[3], a_c[3], lt[3], li[3], Idw[3], Iw[3];
    mvc3(R_k, C + C_COM + 3 * idx, c_w);
    add3(p_k, c_w, x_c);
    cross3(dw_k, c_w, c1);
    cross3(w_k, c_w, c2);
    cross3(w_k, c2, c3);
    for (int i = 0; i < 3; ++i) a_c[i] = dv_k[i] + c1[i] + c3[i];
    const float* Il = C + C_IC + 9 * idx;
    mtv3(R_k, dw_k, lt); cmv3(Il, lt, li); mv3(R_k, li, Idw);
    mtv3(R_k, w_k, lt);  cmv3(Il, lt, li); mv3(R_k, li, Iw);
    const float m = C[C_ML + idx];
    for (int i = 0; i < 3; ++i) Fs[k][i] = a_c[i] * m;
    cross3(w_k, Iw, c1);
    cross3(x_c, Fs[k], c2);
    for (int i = 0; i < 3; ++i) Ms[k][i] = Idw[i] + c1[i] + c2[i];
    for (int i = 0; i < 3; ++i) {
      pjs[k][i] = p_k[i];
      axs[k][i] = a_w[i];
      p_p[i] = p_k[i]; w_p[i] = w_k[i]; v_p[i] = v_k[i];
      dw_p[i] = dw_k[i]; dv_p[i] = dv_k[i];
      for (int j = 0; j < 3; ++j) R_p[i][j] = R_k[i][j];
    }
  }
  // the foot point, its velocity, and the external foot force at it
  float foot[3], c1[3];
  mvc3(R_p, C + C_FOOT + 3 * leg, foot);
  cross3(w_p, foot, c1);
  for (int i = 0; i < 3; ++i) {
    p_foot[i] = p_p[i] + foot[i];
    v_foot[i] = v_p[i] + c1[i];
    Fs[3][i] = -fe3[i];
  }
  cross3(p_foot, Fs[3], Ms[3]);
  // joint k carries links k..2 and the foot force: sums from the foot up,
  // which end as the leg's whole wrench
  for (int i = 0; i < 3; ++i) {
    F[i] = Fs[3][i];
    M[i] = Ms[3][i];
  }
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    float pc[3];
    for (int i = 0; i < 3; ++i) {
      F[i] = F[i] + Fs[k][i];
      M[i] = M[i] + Ms[k][i];
    }
    cross3(pjs[k], F, pc);
    tau3[k] = axs[k][0] * (M[0] - pc[0]) + axs[k][1] * (M[1] - pc[1]) +
              axs[k][2] * (M[2] - pc[2]);
  }
}

// The trunk's Newton-Euler with the legs' summed wrench (F_legs, M_legs):
// tau6 = [base force 3 | Euler-chart base moment 3].
__device__ __forceinline__ void trunk_wrench(const float* C, const Trunk& b,
                                             const float F_legs[3], const float M_legs[3],
                                             float tau6[6]) {
  float c_w[3], x_c[3], a_c[3], c1[3], c2[3], c3[3], lt[3], li[3], Idw[3], Iw[3];
  float F_t[3], M_t[3];
  mvc3(b.R, C + C_COMT, c_w);
  add3(b.p, c_w, x_c);
  cross3(b.dw, c_w, c1);
  cross3(b.w, c_w, c2);
  cross3(b.w, c2, c3);
  for (int i = 0; i < 3; ++i) a_c[i] = b.dv[i] + c1[i] + c3[i];
  mtv3(b.R, b.dw, lt); cmv3(C + C_IT, lt, li); mv3(b.R, li, Idw);
  mtv3(b.R, b.w, lt);  cmv3(C + C_IT, lt, li); mv3(b.R, li, Iw);
  const float m_t = C[C_MT];
  for (int i = 0; i < 3; ++i) F_t[i] = a_c[i] * m_t;
  cross3(b.w, Iw, c1);
  cross3(x_c, F_t, c2);
  for (int i = 0; i < 3; ++i) M_t[i] = Idw[i] + c1[i] + c2[i];
  float F_tot[3], M_tot[3], n_b[3], n_l[3], tang[3];
  add3(F_t, F_legs, F_tot);
  add3(M_t, M_legs, M_tot);
  cross3(b.p, F_tot, c1);
  sub3(M_tot, c1, n_b);   // moment about the base origin
  mtv3(b.R, n_b, n_l);
  mtv3(b.T, n_l, tang);   // Euler-chart generalized force T^T R_b^T n
  for (int i = 0; i < 3; ++i) {
    tau6[i] = F_tot[i];
    tau6[3 + i] = tang[i];
  }
}

// n floats from src (device memory) to dst (shared, 16-byte aligned), the
// block's threads on neighbouring addresses.
__device__ __forceinline__ void stage_in(float* dst, const float* __restrict__ src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n & ~3;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < done / 4; i += DC_THREADS) d4[i] = __ldg(s4 + i);
  }
  for (int i = done + threadIdx.x; i < n; i += DC_THREADS) dst[i] = __ldg(src + i);
}

// n floats from src (shared, 16-byte aligned) to dst (device memory).
__device__ __forceinline__ void stage_out(float* __restrict__ dst, const float* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = n & ~3;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < done / 4; i += DC_THREADS) d4[i] = s4[i];
  }
  for (int i = done + threadIdx.x; i < n; i += DC_THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(DC_THREADS, 2)
dyncore_kernel(const float* __restrict__ X, const float* __restrict__ A,
               const float* __restrict__ F, const float* __restrict__ consts,
               float* __restrict__ out, int M) {
  __shared__ float Cs[N_CONSTS];
  __shared__ __align__(16) float Xs[DC_EVALS * 36];
  __shared__ __align__(16) float As[DC_EVALS * 18];
  __shared__ __align__(16) float Es[DC_EVALS * 12];
  __shared__ __align__(16) float Os[DC_EVALS * DC_OUT];
  const size_t m0 = (size_t)blockIdx.x * DC_EVALS;
  const int n = min(DC_EVALS, M - (int)m0);
  for (int i = threadIdx.x; i < N_CONSTS; i += DC_THREADS) Cs[i] = consts[i];
  stage_in(Xs, X + m0 * 36, n * 36);
  stage_in(As, A + m0 * 18, n * 18);
  stage_in(Es, F + m0 * 12, n * 12);
  __syncthreads();

  const int leg = threadIdx.x & 3;
  // lanes past the last evaluation repeat it (every lane takes part in the
  // shuffles) and store nothing
  const int e = min((int)(threadIdx.x >> 2), n - 1);
  const float* x = Xs + e * 36;
  const float* a = As + e * 18;
  Trunk b;
  trunk_state(x, x + 18, a, b);
  float q3[3], v3[3], a3[3], fe3[3];
  for (int k = 0; k < 3; ++k) {
    q3[k] = x[6 + 3 * leg + k];
    v3[k] = x[24 + 3 * leg + k];
    a3[k] = a[6 + 3 * leg + k];
    fe3[k] = Es[e * 12 + 3 * leg + k];
  }
  float p_foot[3], v_foot[3], tau3[3], Fl[3], Ml[3], tau6[6];
  leg_chain(Cs, leg, b, q3, v3, a3, fe3, p_foot, v_foot, tau3, Fl, Ml);
  for (int s = 1; s <= 2; s <<= 1)
    for (int i = 0; i < 3; ++i) {
      Fl[i] = Fl[i] + __shfl_xor_sync(0xffffffffu, Fl[i], s);
      Ml[i] = Ml[i] + __shfl_xor_sync(0xffffffffu, Ml[i], s);
    }
  trunk_wrench(Cs, b, Fl, Ml, tau6);

  if ((int)(threadIdx.x >> 2) < n) {
    float* o = Os + e * DC_OUT;
    for (int i = 0; i < 3; ++i) {
      o[3 * leg + i] = p_foot[i];
      o[12 + 3 * leg + i] = v_foot[i];
      o[30 + 3 * leg + i] = tau3[i];
    }
    if (leg == 0)
      for (int i = 0; i < 6; ++i) o[24 + i] = tau6[i];
  }
  __syncthreads();
  stage_out(out + m0 * DC_OUT, Os, n * DC_OUT);
}

extern "C" int dyncore_launch(const float* X, const float* A, const float* F,
                              const float* consts, float* out, int M, void* stream) {
  const int blocks = (M + DC_EVALS - 1) / DC_EVALS;
  dyncore_kernel<<<blocks, DC_THREADS, 0, (cudaStream_t)stream>>>(X, A, F, consts, out, M);
  return (int)cudaGetLastError();
}

// The compiled kernel's registers a thread, local bytes a thread (stack
// frame and spills) and resident blocks an SM: out[0..2].
extern "C" int dyncore_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dyncore_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)dyncore_kernel,
                                                      DC_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
