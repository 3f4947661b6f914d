// lingram: linearize the stage residual of every (problem, node) and form
// its Gauss-Newton blocks, G = [Jx | Ju | r]^T [Jx | Ju | r]:
// Q (36x36), R (30x30), M (36x30), qx (36), ru (30).
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:lingram_lane_major
// (_lingram_kernel), whose blocks equal solver/linearize.py:lingram_structured.
// Rows reproduced, in ocp/problem.py:stage_residual order: base/joint
// tracking, acceleration and force regularisation, swing peak, foot
// displacement, patch hinge, base dynamics (+ lam_eq), contact pinning with
// the stab gain, friction-cone hinges, swing clearance and (optionally) the
// torque-limit hinge, all AL-shifted as in the JAX package.
//
// Bound on this card: the Gram (67x67 entries, each a dot over 142 rows,
// ~0.6 MFLOP per node) and the redundant dual passes. Design: one block per
// (problem, node); thread t < 66 pushes ONE forward tangent (x then u
// directions) through the whole residual stack with a width-1 dual, so
// thread t produces Jacobian column t (thread 0 also the residual values);
// the columns meet in shared memory (142 x 67 floats, 38 KB) and the whole
// block forms the upper triangle of the Gram. No tangent ever reaches
// device memory. The TPU kernel's lane-major layout, 128-lane padding and
// analytic mass matrix are not carried over: seeding the acceleration
// directions gives d tau / d a directly.
#include "legdyn.cuh"

#define NZ 66           // 36 state + 30 input directions
#define NCOL 67         // + residual column
#define NROW_MAX 142    // 130 rows + 12 torque-hinge rows

struct RowSink {
  float (*J)[NCOL];
  int col;
  int row;
  __device__ __forceinline__ void operator()(Dual d) {
    J[row][col] = d.t;
    if (col == 0) J[row][NZ] = d.v;
    ++row;
  }
};

// max(g, 0); at g == 0 its derivative is 1/2, the convention of jnp.maximum
// under the JAX package's jacfwd linearization (a foot that enters stance
// with zero warm-start force sits exactly there after a contact switch)
__device__ __forceinline__ Dual relu(Dual g) {
  return g.v > 0.f ? g : Dual(0.f, g.v == 0.f ? 0.5f * g.t : 0.f);
}

// AL-shifted hinge: two-sided affine row g + s where s > 0, max(g, 0) else
__device__ __forceinline__ Dual hinge_shifted(Dual g, float s) {
  return s > 0.f ? g + s : relu(g);
}

__device__ void stage_rows(const float* C, const float* W, const float* P, const Dual* z,
                           int include_torque, RowSink& emit) {
  const Dual* q = z;
  const Dual* v = z + 18;
  const Dual* a = z + 36;
  const Dual* f = z + 54;
  const float* cnt = P + P_CNT;
  const float* bref = P + P_BREF;
  const float* jref = P + P_JREF;
  const float* lam = P + P_LAM;
  const float* lami = P + P_LAMI;
  const float rstr = P[P_RSTR], sh = P[P_SH];

  Dual fe[12];
  for (int i = 0; i < 12; ++i) fe[i] = f[i] * cnt[i / 3];

  // tracking rows
  for (int i = 0; i < 6; ++i) emit((q[i] - bref[i]) * W[W_BASE + i]);
  for (int i = 0; i < 6; ++i) emit((v[i] - bref[6 + i]) * W[W_BASE + 6 + i]);
  for (int i = 0; i < 12; ++i) emit((q[6 + i] - jref[i]) * W[W_JOINT + i]);
  for (int i = 0; i < 12; ++i) emit(v[6 + i] * W[W_JOINT + 12 + i]);
  for (int i = 0; i < 12; ++i) emit(a[6 + i] * W[W_ACC + i]);
  // force regularisation toward the gravity share; swing forces pinned at 0
  float n_act = fmaxf(cnt[0] + cnt[1] + cnt[2] + cnt[3], 1.f);
  for (int i = 0; i < 12; ++i) {
    const float fref = (i % 3 == 2) ? cnt[i / 3] * W[W_TOTALW] / n_act : 0.f;
    emit((fe[i] - fref) * W[W_FREG + i]);
  }
  for (int i = 0; i < 12; ++i) emit(f[i] * (1.f - cnt[i / 3]));

  Dual pf[12], vf[12], tau[18];
  body_pass<Dual>(C, q, v, a, fe, pf, vf, tau);

  for (int i = 0; i < 4; ++i)
    emit(((pf[3 * i + 2] - sh) * P[P_PEAK + i]) * W[W_SWING + i]);
  for (int i = 0; i < 4; ++i)
    for (int c = 0; c < 2; ++c)
      emit((pf[3 * i + c] - P[P_LOC + 2 * i + c]) * (rstr * cnt[i]) * W[W_FOOTDISP]);
  for (int i = 0; i < 4; ++i) {
    Dual dx = pf[3 * i] - P[P_LOC + 2 * i];
    Dual dy = pf[3 * i + 1] - P[P_LOC + 2 * i + 1];
    Dual d2 = dx * dx + dy * dy + 1.0e-12f;
    float dist_v = sqrtf(d2.v);
    Dual dist(dist_v, 0.5f * d2.t / dist_v);
    Dual core = hinge_shifted(dist - P[P_PATCH + i], lami[32 + i]);
    emit(core * (rstr * cnt[i]) * W[W_PATCH]);
  }
  for (int i = 0; i < 6; ++i) emit(tau[i] * W[W_DYN] + lam[i]);
  for (int i = 0; i < 4; ++i) {
    const float s = cnt[i] * W[W_CVEL];
    emit(vf[3 * i] * s + cnt[i] * lam[6 + 3 * i]);
    emit(vf[3 * i + 1] * s + cnt[i] * lam[6 + 3 * i + 1]);
    Dual pin_z = vf[3 * i + 2] + (pf[3 * i + 2] - P[P_PLZ + i]) * W[W_STAB + i];
    emit(pin_z * s + cnt[i] * lam[6 + 3 * i + 2]);
  }
  const float mu = W[W_MU];
  for (int i = 0; i < 4; ++i) {
    const Dual fx = fe[3 * i], fy = fe[3 * i + 1], fz = fe[3 * i + 2];
    const Dual g[5] = {-fz, fx - fz * mu, -fx - fz * mu, fy - fz * mu, -fy - fz * mu};
    for (int r = 0; r < 5; ++r)
      emit(hinge_shifted(g[r], cnt[i] * lami[5 * i + r]) * W[W_CONE]);
  }
  for (int i = 0; i < 4; ++i)
    emit(relu(P[P_PLZ + i] - pf[3 * i + 2]) * ((1.f - cnt[i]) * W[W_CLEAR]));
  if (include_torque) {
    for (int j = 0; j < 12; ++j) {
      Dual t = tau[6 + j];
      Dual at = t.v < 0.f ? -t : (t.v > 0.f ? t : Dual(0.f, 0.f));
      emit(hinge_shifted(at - W[W_TLIM + j], lami[20 + j]) * W[W_TORQUE]);
    }
  }
}

__global__ void __launch_bounds__(128)
lingram_kernel(const float* __restrict__ X, const float* __restrict__ U,
               const float* __restrict__ Par, const float* __restrict__ consts,
               const float* __restrict__ wts, float* __restrict__ Qo,
               float* __restrict__ Ro, float* __restrict__ Mo,
               float* __restrict__ qxo, float* __restrict__ ruo, int include_torque) {
  __shared__ float Cs[N_CONSTS];
  __shared__ float Ws[N_WEIGHTS];
  __shared__ float Ps[N_NODE_PAR];
  __shared__ float Zs[NZ];
  __shared__ float J[NROW_MAX][NCOL];
  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < N_CONSTS; i += blockDim.x) Cs[i] = consts[i];
  for (int i = tid; i < N_WEIGHTS; i += blockDim.x) Ws[i] = wts[i];
  for (int i = tid; i < N_NODE_PAR; i += blockDim.x) Ps[i] = Par[(size_t)node * N_NODE_PAR + i];
  for (int i = tid; i < 36; i += blockDim.x) Zs[i] = X[(size_t)node * 36 + i];
  for (int i = tid; i < 30; i += blockDim.x) Zs[36 + i] = U[(size_t)node * 30 + i];
  __syncthreads();

  const int nrows = include_torque ? NROW_MAX : NROW_MAX - 12;
  if (tid < NZ) {
    Dual z[NZ];
    for (int i = 0; i < NZ; ++i) z[i] = Dual(Zs[i], i == tid ? 1.f : 0.f);
    RowSink emit{J, tid, 0};
    stage_rows(Cs, Ws, Ps, z, include_torque, emit);
  }
  __syncthreads();

  // upper triangle of the Gram (the (r, r) corner is not needed)
  float* Q = Qo + (size_t)node * 36 * 36;
  float* R = Ro + (size_t)node * 30 * 30;
  float* M = Mo + (size_t)node * 36 * 30;
  for (int e = tid; e < NCOL * NCOL; e += blockDim.x) {
    const int i = e / NCOL, j = e % NCOL;
    if (j < i || i == NZ) continue;
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += J[r][i] * J[r][j];
    if (j < 36) {
      Q[i * 36 + j] = s;
      Q[j * 36 + i] = s;
    } else if (j < NZ) {
      if (i < 36) {
        M[i * 30 + (j - 36)] = s;
      } else {
        R[(i - 36) * 30 + (j - 36)] = s;
        R[(j - 36) * 30 + (i - 36)] = s;
      }
    } else if (i < 36) {
      qxo[(size_t)node * 36 + i] = s;
    } else {
      ruo[(size_t)node * 30 + (i - 36)] = s;
    }
  }
}

extern "C" int lingram_launch(const float* X, const float* U, const float* Par,
                              const float* consts, const float* wts, float* Q, float* R,
                              float* M, float* qx, float* ru, int BN, int include_torque,
                              void* stream) {
  lingram_kernel<<<BN, 128, 0, (cudaStream_t)stream>>>(X, U, Par, consts, wts, Q, R, M, qx,
                                                       ru, include_torque);
  return (int)cudaGetLastError();
}
