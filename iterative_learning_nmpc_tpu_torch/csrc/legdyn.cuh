// Whole-body quadruped kinematics and inverse dynamics for one evaluation,
// templated on the scalar type: `float`, or `Dual` (a value and ONE forward
// tangent). The CUDA form of the JAX package's dual-number pass
// (iterative_learning_nmpc_tpu/ops/dynjac_kernel.py: class D, _dual_pass,
// fk_feet_dual), which mirrors models/dynamics.py (_leg_kinematics, rnea).
//
// Robot constants are read from a small float buffer (layout below, built by
// ops/layout.py robot_consts from the spec), not baked into the source, so
// another quadruped needs no new code. Callers stage the buffer in shared
// memory.
#pragma once
#include <cuda_runtime.h>

// ---- buffer layouts: keep in sync with ops/layout.py ----------------------
// robot constants
#define C_JP 0        // leg joint offsets (4 legs x 3 links x 3)
#define C_AX 36       // leg joint axes
#define C_ML 72       // leg link masses (4 x 3)
#define C_COM 84      // leg link CoMs (4 x 3 x 3)
#define C_IC 120      // leg link inertias (4 x 3 x 3 x 3)
#define C_FOOT 228    // foot offsets (4 x 3)
#define C_MT 240      // trunk mass
#define C_COMT 241    // trunk CoM (3)
#define C_IT 244      // trunk inertia (3 x 3)
#define N_CONSTS 253
// cost weights
#define W_BASE 0
#define W_JOINT 12
#define W_ACC 36
#define W_SWING 48
#define W_FREG 52
#define W_FOOTDISP 64
#define W_STAB 65
#define W_DYN 69
#define W_CVEL 70
#define W_CONE 71
#define W_CLEAR 72
#define W_TORQUE 73
#define W_PATCH 74
#define W_MU 75
#define W_TOTALW 76
#define W_TLIM 77
#define N_WEIGHTS 89
// per-node OCP parameters
#define P_CNT 0
#define P_PEAK 4
#define P_PLZ 8
#define P_LOC 12
#define P_PATCH 20
#define P_RSTR 24
#define P_BREF 25
#define P_JREF 37
#define P_SH 49
#define P_LAM 50
#define P_LAMI 68
#define N_NODE_PAR 104

#define LEG_GRAVITY 9.81f

// ---- scalars ---------------------------------------------------------------
struct Dual {
  float v, t;
  __device__ __forceinline__ Dual() : v(0.f), t(0.f) {}
  __device__ __forceinline__ Dual(float v_, float t_ = 0.f) : v(v_), t(t_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.t + b.t); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.t - b.t); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.t); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return Dual(a.v * b.v, a.v * b.t + a.t * b.v); }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return Dual(a.v + b, a.t); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a + b.v, b.t); }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return Dual(a.v - b, a.t); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.t); }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.t * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.t); }

__device__ __forceinline__ float s_sin(float x) { return sinf(x); }
__device__ __forceinline__ float s_cos(float x) { return cosf(x); }
__device__ __forceinline__ Dual s_sin(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.t); }
__device__ __forceinline__ Dual s_cos(Dual x) { return Dual(cosf(x.v), -sinf(x.v) * x.t); }
__device__ __forceinline__ float s_val(float x) { return x; }
__device__ __forceinline__ float s_val(Dual x) { return x.v; }

// ---- 3-vector / 3x3 helpers (outputs never alias inputs) -------------------
template <class S>
__device__ __forceinline__ void cross3(const S a[3], const S b[3], S o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <class S>
__device__ __forceinline__ void add3(const S a[3], const S b[3], S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = a[i] + b[i];
}

template <class S>
__device__ __forceinline__ void sub3(const S a[3], const S b[3], S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = a[i] - b[i];
}

template <class S>
__device__ __forceinline__ void mv3(const S M[3][3], const S x[3], S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = M[i][0] * x[0] + M[i][1] * x[1] + M[i][2] * x[2];
}

template <class S>
__device__ __forceinline__ void mtv3(const S M[3][3], const S x[3], S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = M[0][i] * x[0] + M[1][i] * x[1] + M[2][i] * x[2];
}

// M (scalar) times a constant vector c
template <class S>
__device__ __forceinline__ void mvc3(const S M[3][3], const float* c, S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = M[i][0] * c[0] + M[i][1] * c[1] + M[i][2] * c[2];
}

// constant 3x3 I (row-major) times x
template <class S>
__device__ __forceinline__ void cmv3(const float* I, const S x[3], S o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = I[3 * i] * x[0] + I[3 * i + 1] * x[1] + I[3 * i + 2] * x[2];
}

template <class S>
__device__ __forceinline__ void mm3(const S A[3][3], const S B[3][3], S O[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      O[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

// R = I + s K + (1 - c) K K about a constant unit axis
template <class S>
__device__ __forceinline__ void rodrigues(const float* ax, S c, S s, S R[3][3]) {
  const float K[3][3] = {{0.f, -ax[2], ax[1]}, {ax[2], 0.f, -ax[0]}, {-ax[1], ax[0], 0.f}};
  S omc = 1.f - c;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      R[i][j] = s * K[i][j] + omc * kk + (i == j ? 1.f : 0.f);
    }
}

// R = Rz(yaw) Ry(pitch) Rx(roll)
template <class S>
__device__ __forceinline__ void ypr_matrix(S cy, S sy, S cp, S sp, S cr, S sr, S R[3][3]) {
  R[0][0] = cy * cp; R[0][1] = cy * sp * sr - sy * cr; R[0][2] = cy * sp * cr + sy * sr;
  R[1][0] = sy * cp; R[1][1] = sy * sp * sr + cy * cr; R[1][2] = sy * sp * cr - cy * sr;
  R[2][0] = -sp;     R[2][1] = cp * sr;                R[2][2] = cp * cr;
}

// ---- foot positions only (terminal Gram) -----------------------------------
template <class S>
__device__ void feet_positions(const float* C, const S* q, S* p_feet) {
  S R_b[3][3];
  ypr_matrix(s_cos(q[3]), s_sin(q[3]), s_cos(q[4]), s_sin(q[4]), s_cos(q[5]), s_sin(q[5]), R_b);
#pragma unroll 1
  for (int leg = 0; leg < 4; ++leg) {
    S R_p[3][3], p_p[3] = {q[0], q[1], q[2]};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) R_p[i][j] = R_b[i][j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int idx = 3 * leg + k;
      S off[3], p_k[3], Rot[3][3], R_k[3][3];
      mvc3(R_p, C + C_JP + 3 * idx, off);
      add3(p_p, off, p_k);
      rodrigues(C + C_AX + 3 * idx, s_cos(q[6 + idx]), s_sin(q[6 + idx]), Rot);
      mm3(R_p, Rot, R_k);
      for (int i = 0; i < 3; ++i) {
        p_p[i] = p_k[i];
        for (int j = 0; j < 3; ++j) R_p[i][j] = R_k[i][j];
      }
    }
    S foot[3];
    mvc3(R_p, C + C_FOOT + 3 * leg, foot);
    for (int i = 0; i < 3; ++i) p_feet[3 * leg + i] = p_p[i] + foot[i];
  }
}

// ---- FK + foot velocities + RNEA -------------------------------------------
// q, v, a: 18 each; fe: 12 world foot forces (already contact-masked).
// Outputs p_feet 12, v_feet 12, tau 18 (base force 3, Euler-chart base
// moment 3, joints 12). ``grav`` = 0 with v = 0 and fe = 0 turns the pass
// into one column of the mass matrix per unit acceleration.
template <class S>
__device__ void body_pass(const float* C, const S* q, const S* v, const S* a, const S* fe,
                          S* p_feet, S* v_feet, S* tau, float grav = LEG_GRAVITY) {
  const S cy = s_cos(q[3]), sy = s_sin(q[3]);
  const S cp = s_cos(q[4]), sp = s_sin(q[4]);
  const S cr = s_cos(q[5]), sr = s_sin(q[5]);
  S R_b[3][3];
  ypr_matrix(cy, sy, cp, sp, cr, sr, R_b);
  const S z0(0.f);
  // T: ypr rates -> body angular velocity; Td = dT/dt
  const S T[3][3] = {{-sp, z0, S(1.f)}, {cp * sr, cr, z0}, {cp * cr, -sr, z0}};
  const S pd = v[4], rd = v[5];
  const S Td[3][3] = {{-cp * pd, z0, z0},
                      {-sp * pd * sr + cp * cr * rd, -sr * rd, z0},
                      {-sp * pd * cr - cp * sr * rd, -cr * rd, z0}};
  const S yd[3] = {v[3], v[4], v[5]};
  const S ydd[3] = {a[3], a[4], a[5]};
  S w_l[3], w_b[3], t1[3], t2[3], wl_dot[3], dw_b[3];
  mv3(T, yd, w_l);
  mv3(R_b, w_l, w_b);
  mv3(Td, yd, t1);
  mv3(T, ydd, t2);
  add3(t1, t2, wl_dot);
  mv3(R_b, wl_dot, dw_b);  // d/dt (R_b w_l) = R_b wl_dot (R_b' w_l = R_b (w_l x w_l) = 0)
  const S p_b[3] = {q[0], q[1], q[2]};
  const S v_b[3] = {v[0], v[1], v[2]};
  const S dv_b[3] = {a[0], a[1], a[2] + grav};  // gravity as base acceleration

  S F_legs[3] = {z0, z0, z0}, M_legs[3] = {z0, z0, z0};
#pragma unroll 1
  for (int leg = 0; leg < 4; ++leg) {
    S R_p[3][3], p_p[3], w_p[3], v_p[3], dw_p[3], dv_p[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) R_p[i][j] = R_b[i][j];
      p_p[i] = p_b[i]; w_p[i] = w_b[i]; v_p[i] = v_b[i];
      dw_p[i] = dw_b[i]; dv_p[i] = dv_b[i];
    }
    S Fs[4][3], Ms[4][3], pjs[3][3], axs[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int idx = 3 * leg + k;
      const float* axis = C + C_AX + 3 * idx;
      S a_w[3], off[3], p_k[3], r[3], Rot[3][3], R_k[3][3];
      mvc3(R_p, axis, a_w);
      rodrigues(axis, s_cos(q[6 + idx]), s_sin(q[6 + idx]), Rot);
      mm3(R_p, Rot, R_k);
      mvc3(R_p, C + C_JP + 3 * idx, off);
      add3(p_p, off, p_k);
      sub3(p_k, p_p, r);
      const S qd = v[6 + idx], qdd = a[6 + idx];
      S c1[3], c2[3], c3[3], v_k[3], dv_k[3], w_k[3], dw_k[3], awqd[3];
      cross3(w_p, r, c1);
      add3(v_p, c1, v_k);
      cross3(dw_p, r, c1);
      cross3(w_p, r, c2);
      cross3(w_p, c2, c3);
      for (int i = 0; i < 3; ++i) dv_k[i] = dv_p[i] + c1[i] + c3[i];
      for (int i = 0; i < 3; ++i) {
        awqd[i] = a_w[i] * qd;
        w_k[i] = w_p[i] + awqd[i];
      }
      cross3(w_p, awqd, c1);
      for (int i = 0; i < 3; ++i) dw_k[i] = dw_p[i] + a_w[i] * qdd + c1[i];
      // Newton-Euler about the link CoM, inertia products in the body frame
      S c_w[3], x_c[3], a_c[3], lt[3], li[3], Idw[3], Iw[3];
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
    // foot point, its velocity, and the external foot force at it
    S foot[3], p_f[3], rf[3], c1[3];
    mvc3(R_p, C + C_FOOT + 3 * leg, foot);
    add3(pjs[2], foot, p_f);
    sub3(p_f, pjs[2], rf);
    cross3(w_p, rf, c1);
    for (int i = 0; i < 3; ++i) {
      p_feet[3 * leg + i] = p_f[i];
      v_feet[3 * leg + i] = v_p[i] + c1[i];
      Fs[3][i] = -fe[3 * leg + i];
    }
    cross3(p_f, Fs[3], Ms[3]);
    // joint k supports links k..2 and the foot force
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      S SF[3], SM[3], pc[3];
      for (int i = 0; i < 3; ++i) {
        SF[i] = Fs[k][i];
        SM[i] = Ms[k][i];
        for (int n = k + 1; n < 4; ++n) {
          SF[i] = SF[i] + Fs[n][i];
          SM[i] = SM[i] + Ms[n][i];
        }
      }
      cross3(pjs[k], SF, pc);
      tau[6 + 3 * leg + k] = axs[k][0] * (SM[0] - pc[0]) + axs[k][1] * (SM[1] - pc[1]) +
                             axs[k][2] * (SM[2] - pc[2]);
    }
    for (int i = 0; i < 3; ++i)
      for (int n = 0; n < 4; ++n) {
        F_legs[i] = F_legs[i] + Fs[n][i];
        M_legs[i] = M_legs[i] + Ms[n][i];
      }
  }

  // trunk Newton-Euler
  S c_w[3], x_c[3], a_c[3], c1[3], c2[3], c3[3], lt[3], li[3], Idw[3], Iw[3], F_t[3], M_t[3];
  mvc3(R_b, C + C_COMT, c_w);
  add3(p_b, c_w, x_c);
  cross3(dw_b, c_w, c1);
  cross3(w_b, c_w, c2);
  cross3(w_b, c2, c3);
  for (int i = 0; i < 3; ++i) a_c[i] = dv_b[i] + c1[i] + c3[i];
  mtv3(R_b, dw_b, lt); cmv3(C + C_IT, lt, li); mv3(R_b, li, Idw);
  mtv3(R_b, w_b, lt);  cmv3(C + C_IT, lt, li); mv3(R_b, li, Iw);
  const float m_t = C[C_MT];
  for (int i = 0; i < 3; ++i) F_t[i] = a_c[i] * m_t;
  cross3(w_b, Iw, c1);
  cross3(x_c, F_t, c2);
  for (int i = 0; i < 3; ++i) M_t[i] = Idw[i] + c1[i] + c2[i];

  S F_tot[3], M_tot[3], n_b[3], n_l[3], tang[3];
  add3(F_t, F_legs, F_tot);
  add3(M_t, M_legs, M_tot);
  cross3(p_b, F_tot, c1);
  sub3(M_tot, c1, n_b);   // moment about the base origin
  mtv3(R_b, n_b, n_l);
  mtv3(T, n_l, tang);     // Euler-chart generalized force T^T R_b^T n
  for (int i = 0; i < 3; ++i) {
    tau[i] = F_tot[i];
    tau[3 + i] = tang[i];
  }
}

// ---- the body pass split by leg (dyncore, dynjac) ---------------------------
// The same recursion as body_pass, cut where the legs meet the trunk:
// trunk_state (the trunk's frame and motion), leg_chain (one leg's three
// links, foot and joint torques, and the wrench the leg puts on the
// trunk), trunk_wrench (the trunk's Newton-Euler with the legs' summed
// wrench). Every per-thread array is indexed statically, so a caller that
// runs a leg per thread keeps them in registers. S is float (dyncore) or
// Dual (dynjac: one tangent direction a thread).

// The trunk's pose, rates and accelerations (world frame) and T, the
// Euler-rate map, from an evaluation's base coordinates; gravity enters as
// a base acceleration.
template <class S>
struct Trunk {
  S R[3][3], T[3][3], p[3], v[3], w[3], dv[3], dw[3];
};

template <class S>
__device__ __forceinline__ void trunk_state(const S* q, const S* v, const S* a, Trunk<S>& b) {
  const S cy = s_cos(q[3]), sy = s_sin(q[3]);
  const S cp = s_cos(q[4]), sp = s_sin(q[4]);
  const S cr = s_cos(q[5]), sr = s_sin(q[5]);
  ypr_matrix(cy, sy, cp, sp, cr, sr, b.R);
  const S z0(0.f), one(1.f);
  const S T[3][3] = {{-sp, z0, one}, {cp * sr, cr, z0}, {cp * cr, -sr, z0}};
  const S pd = v[4], rd = v[5];
  const S Td[3][3] = {{-cp * pd, z0, z0},
                      {-sp * pd * sr + cp * cr * rd, -sr * rd, z0},
                      {-sp * pd * cr - cp * sr * rd, -cr * rd, z0}};
  const S yd[3] = {v[3], v[4], v[5]};
  const S ydd[3] = {a[3], a[4], a[5]};
  S w_l[3], t1[3], t2[3], wl_dot[3];
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
template <class S>
__device__ __forceinline__ void leg_chain(const float* C, int leg, const Trunk<S>& b,
                                          const S q3[3], const S v3[3], const S a3[3],
                                          const S fe3[3], S p_foot[3], S v_foot[3], S tau3[3],
                                          S F[3], S M[3]) {
  S R_p[3][3], p_p[3], w_p[3], v_p[3], dw_p[3], dv_p[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R_p[i][j] = b.R[i][j];
    p_p[i] = b.p[i]; w_p[i] = b.w[i]; v_p[i] = b.v[i];
    dw_p[i] = b.dw[i]; dv_p[i] = b.dv[i];
  }
  S Fs[4][3], Ms[4][3], pjs[3][3], axs[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int idx = 3 * leg + k;
    const float* axis = C + C_AX + 3 * idx;
    S a_w[3], off[3], p_k[3], Rot[3][3], R_k[3][3];
    mvc3(R_p, axis, a_w);
    rodrigues(axis, s_cos(q3[k]), s_sin(q3[k]), Rot);
    mm3(R_p, Rot, R_k);
    mvc3(R_p, C + C_JP + 3 * idx, off);
    add3(p_p, off, p_k);
    S c1[3], c2[3], c3[3], v_k[3], dv_k[3], w_k[3], dw_k[3], awqd[3];
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
    S c_w[3], x_c[3], a_c[3], lt[3], li[3], Idw[3], Iw[3];
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
  S foot[3], c1[3];
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
    S pc[3];
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
template <class S>
__device__ __forceinline__ void trunk_wrench(const float* C, const Trunk<S>& b,
                                             const S F_legs[3], const S M_legs[3], S tau6[6]) {
  S c_w[3], x_c[3], a_c[3], c1[3], c2[3], c3[3], lt[3], li[3], Idw[3], Iw[3];
  S F_t[3], M_t[3];
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
  S F_tot[3], M_tot[3], n_b[3], n_l[3], tang[3];
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
