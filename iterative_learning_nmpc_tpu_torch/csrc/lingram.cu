// lingram: linearize the stage residual of every (problem, node) and form
// its Gauss-Newton blocks, G = [Jx | Ju | r]^T [Jx | Ju | r]:
// Q (36x36), R (30x30), M (36x30), qx (36), ru (30).
//
// Replaces iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:lingram_lane_major
// (_lingram_kernel), whose blocks equal solver/linearize.py:lingram_structured.
// Rows, in ocp/problem.py:stage_residual's terms: base/joint tracking,
// acceleration and force regularisation, swing peak, foot displacement,
// patch hinge, base dynamics (+ lam_eq), contact pinning with the stab gain,
// friction-cone hinges, swing clearance and (optionally) the torque-limit
// hinge, all AL-shifted as in the JAX package.
//
// The 142 x 67 Jacobian is never formed: G has no cross-row terms, so it is
// summed row group by row group.
// - Diagonal groups (tracking, acceleration, force regularisation with
//   swing pinning) and the friction-cone rows (a 3x3 block per foot, whose
//   five gradients are constant) are closed forms.
// - D: the dynamics rows (+ torque-hinge rows), the only rows with x and u
//   columns, over x 36 | a 18 | f 12 | residual.
// - Sp: the contact-pin rows, over x 36 | residual.
// - Sq: the position-only rows (swing peak, foot displacement, patch hinge,
//   swing clearance), over q 18 | residual: the TPU kernel's q-block.
// Derivatives: ONE forward tangent per x direction (36 Dual passes of
// legdyn.cuh's body_pass per node); no a or f direction is seeded.
// d tau / d a = M(q) comes from 18 values-only passes at unit acceleration
// with v = 0, fe = 0 and gravity off; d tau / d f_eff = -(d v_foot / d v)^T
// by duality, read off the v-direction passes.
//
// Bound on this card: the derivative passes, each a long dependent scalar
// chain that needs ~255 registers a thread (so at most 8 warps per SM run
// them), then the blocks' 13,368 B per node of stores (171 MB per B=512,
// N=25 call, ~0.05 ms at 3.35 TB/s). The parts have different needs, so
// they are three launches on the caller's stream:
// 1. lingram_rows_kernel: a block takes ROWS_NODES = 7 nodes with
//    ROWS_THREADS = 256 threads, 7 * 36 <= 256, so the passes fill whole
//    warps. Chosen on the card against 3 nodes / 128 threads and 14 / 512,
//    whose 128-register cap spills; capping 7 / 256 by __launch_bounds__
//    was slower still: the spills cost more than the extra warps gain
//    (PERF.md, kernel 2). Thread t < 7*36 runs the Dual pass of direction
//    t % 36 of node t / 36 and writes column t % 36 of that node's D, Sp
//    and Sq to a row buffer in device memory (a warp stores consecutive
//    columns); direction 0 also writes the residuals, the row scales and
//    the closed forms.
// 2. lingram_mass_kernel: 7 nodes x 18 columns of M per 128-thread block,
//    a values-only pass each (96 registers, so 5 blocks per SM), written
//    unscaled into D's a columns.
// 3. lingram_gram_kernel: 40 registers, so many warps per SM. A block of
//    256 threads stages GN_NODES nodes' rows (8,896 B each) in shared
//    memory with 16-byte loads, scales M's rows, and forms the nodes'
//    [Q | M | R | qx | ru] in 2x2 register tiles (two 8-byte shared loads
//    per 4 multiply-adds; both triangles of Q and R), consecutive threads
//    on consecutive tiles of a row, stored as 8-byte pairs in the outputs'
//    row order.
// The row buffer costs 8,896 B per node each way (114 MB per B=512 call).
// fp32 on the CUDA cores.
#include "legdyn.cuh"

#define LG_ND 18        // dynamics 6 + torque-hinge 12 rows
#define LG_NP 12        // contact-pin rows
#define LG_NQ 20        // position-only rows
#define LG_TILES (18 * 18 + 18 * 15 + 15 * 15 + 18 + 15)   // 2x2 tiles per node
#define ROWS_NODES 7    // nodes per block of the rows kernel
#define ROWS_THREADS 256
#define GN_NODES 2      // nodes per block of the Gram kernel
#define GN_THREADS 256
#define MASS_NODES 7    // nodes per block of the mass kernel
#define MASS_THREADS 128

// One node's row groups, as the rows kernel writes them to device memory;
// even row strides, so that 2x2 tiles read 8-byte pairs. ops/lingram.py
// allocates lingram_row_floats() floats per node.
struct NodeRows {
  float D[LG_ND][68];           // x 36 | a 18 | f 12 | residual | row scale
  float Sp[LG_NP][38];          // x 36 | residual | pad
  float Sq[LG_NQ][20];          // q 18 | residual | pad
  float Rd[30], ru0[30], qx0[36];   // diagonal groups
  float cone[4][3][4];          // per foot: 3x3 Gram block | ru
};
static_assert(sizeof(NodeRows) % 16 == 0, "the Gram kernel stages rows in 16-byte loads");

// One node's inputs, staged in shared memory by the rows kernel.
struct NodeIn {
  float P[N_NODE_PAR];
  float Z[66];                  // x 36 | u 30
};

// d max(g, 0) / d g with the slope 1/2 at g == 0, the convention of
// jnp.maximum under the JAX package's jacfwd linearization (a foot that
// enters stance with zero warm-start force sits exactly there after a
// contact switch)
__device__ __forceinline__ float hinge_slope(float g) {
  return g > 0.f ? 1.f : (g == 0.f ? 0.5f : 0.f);
}

// AL-shifted hinge: the two-sided affine row g + s where s > 0, max(g, 0) else
__device__ __forceinline__ float shifted_slope(float g, float s) {
  return s > 0.f ? 1.f : hinge_slope(g);
}
__device__ __forceinline__ float shifted_value(float g, float s) {
  return s > 0.f ? g + s : fmaxf(g, 0.f);
}

// The closed-form groups of one node: diagonal rows and friction cones.
__device__ void closed_forms(const float* Ws, const NodeIn& In, NodeRows& S) {
  const float* P = In.P;
  const float* cnt = P + P_CNT;
  const float* lami = P + P_LAMI;
  const float* acc = In.Z + 36;
  const float* f = In.Z + 54;
  // tracking rows, x order: base pos 6, joint pos 12, base vel 6, joint vel 12
  for (int i = 0; i < 6; ++i) {
    const float wq = Ws[W_BASE + i], wv = Ws[W_BASE + 6 + i];
    S.qx0[i] = wq * wq * (In.Z[i] - P[P_BREF + i]);
    S.qx0[18 + i] = wv * wv * (In.Z[18 + i] - P[P_BREF + 6 + i]);
  }
  for (int i = 0; i < 12; ++i) {
    const float wq = Ws[W_JOINT + i], wv = Ws[W_JOINT + 12 + i];
    S.qx0[6 + i] = wq * wq * (In.Z[6 + i] - P[P_JREF + i]);
    S.qx0[24 + i] = wv * wv * In.Z[24 + i];
  }
  // acceleration rows; force regularisation toward the gravity share, with
  // swing forces pinned at 0
  for (int k = 0; k < 6; ++k) S.Rd[k] = S.ru0[k] = 0.f;
  for (int k = 0; k < 12; ++k) {
    const float wa = Ws[W_ACC + k];
    S.Rd[6 + k] = wa * wa;
    S.ru0[6 + k] = wa * wa * acc[6 + k];
  }
  const float n_act = fmaxf(cnt[0] + cnt[1] + cnt[2] + cnt[3], 1.f);
  for (int k = 0; k < 12; ++k) {
    const float c = cnt[k / 3], omc = 1.f - c, wf = Ws[W_FREG + k];
    const float fref = (k % 3 == 2) ? c * Ws[W_TOTALW] / n_act : 0.f;
    S.Rd[18 + k] = c * c * wf * wf + omc * omc;
    S.ru0[18 + k] = c * wf * wf * (f[k] * c - fref) + omc * omc * f[k];
  }
  // friction cones: five rows per foot with constant gradients on f
  const float mu = Ws[W_MU], wc = Ws[W_CONE];
  for (int i = 0; i < 4; ++i) {
    const float c = cnt[i];
    const float fx = f[3 * i] * c, fy = f[3 * i + 1] * c, fz = f[3 * i + 2] * c;
    const float g[5] = {-fz, fx - fz * mu, -fx - fz * mu, fy - fz * mu, -fy - fz * mu};
    float a2[5], as[5];
    for (int r = 0; r < 5; ++r) {
      const float s = c * lami[5 * i + r];
      const float act = shifted_slope(g[r], s) * wc * c;
      a2[r] = act * act;
      as[r] = act * shifted_value(g[r], s) * wc;
    }
    float (*G)[4] = S.cone[i];
    G[0][0] = a2[1] + a2[2];
    G[1][1] = a2[3] + a2[4];
    G[2][2] = a2[0] + mu * mu * (a2[1] + a2[2] + a2[3] + a2[4]);
    G[0][1] = G[1][0] = 0.f;
    G[0][2] = G[2][0] = mu * (a2[2] - a2[1]);
    G[1][2] = G[2][1] = mu * (a2[4] - a2[3]);
    G[0][3] = as[1] - as[2];
    G[1][3] = as[3] - as[4];
    G[2][3] = -as[0] - mu * (as[1] + as[2] + as[3] + as[4]);
  }
}

// The Dual pass of one node along x direction d (< 36), then column d of
// D, Sp and Sq; direction d = 18 + r also writes the f columns of D row r,
// and direction 0 the residual column, the row scales and the closed forms.
__device__ void direction_pass(const float* Cs, const float* Ws, const NodeIn& In, NodeRows& S,
                               int d, int nD) {
  const float* P = In.P;
  const float* cnt = P + P_CNT;
  const float* lam = P + P_LAM;
  const float* lami = P + P_LAMI;
  Dual q[18], v[18], a[18], fe[12];
  for (int i = 0; i < 18; ++i) {
    q[i] = Dual(In.Z[i], i == d ? 1.f : 0.f);
    v[i] = Dual(In.Z[18 + i], 18 + i == d ? 1.f : 0.f);
    a[i] = Dual(In.Z[36 + i]);
  }
  for (int i = 0; i < 12; ++i) fe[i] = Dual(In.Z[54 + i] * cnt[i / 3]);
  Dual pf[12], vf[12], tau[18];
  body_pass<Dual>(Cs, q, v, a, fe, pf, vf, tau);

  const bool res = d == 0;
  const float rstr = P[P_RSTR], sh = P[P_SH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Dual px = pf[3 * i], py = pf[3 * i + 1], pz = pf[3 * i + 2];
    const float c = cnt[i], plz = P[P_PLZ + i];
    // position-only rows (their v tangents are exactly 0)
    const float s_sw = P[P_PEAK + i] * Ws[W_SWING + i];
    const float s_d = rstr * c * Ws[W_FOOTDISP];
    const float dx = px.v - P[P_LOC + 2 * i], dy = py.v - P[P_LOC + 2 * i + 1];
    const float dist = sqrtf(dx * dx + dy * dy + 1.0e-12f);
    const float gp = dist - P[P_PATCH + i], sp = lami[32 + i];
    const float s_p = rstr * c * Ws[W_PATCH];
    const float gc = plz - pz.v;
    const float s_c = (1.f - c) * Ws[W_CLEAR];
    if (d < 18) {
      S.Sq[i][d] = s_sw * pz.t;
      S.Sq[4 + 2 * i][d] = s_d * px.t;
      S.Sq[5 + 2 * i][d] = s_d * py.t;
      S.Sq[12 + i][d] = s_p * shifted_slope(gp, sp) * (dx * px.t + dy * py.t) / dist;
      S.Sq[16 + i][d] = -s_c * hinge_slope(gc) * pz.t;
    }
    // contact pinning: xy velocity and the stabilised z row
    const float s_v = c * Ws[W_CVEL], stab = Ws[W_STAB + i];
    S.Sp[3 * i][d] = s_v * vf[3 * i].t;
    S.Sp[3 * i + 1][d] = s_v * vf[3 * i + 1].t;
    S.Sp[3 * i + 2][d] = s_v * (vf[3 * i + 2].t + stab * pz.t);
    if (res) {
      S.Sq[i][18] = s_sw * (pz.v - sh);
      S.Sq[4 + 2 * i][18] = s_d * dx;
      S.Sq[5 + 2 * i][18] = s_d * dy;
      S.Sq[12 + i][18] = s_p * shifted_value(gp, sp);
      S.Sq[16 + i][18] = s_c * fmaxf(gc, 0.f);
      S.Sp[3 * i][36] = s_v * vf[3 * i].v + c * lam[6 + 3 * i];
      S.Sp[3 * i + 1][36] = s_v * vf[3 * i + 1].v + c * lam[6 + 3 * i + 1];
      S.Sp[3 * i + 2][36] = s_v * (vf[3 * i + 2].v + stab * (pz.v - plz)) + c * lam[6 + 3 * i + 2];
    }
  }
  // dynamics rows, then the torque hinge |tau_j| - limit (sign(0) = 0);
  // unrolled, so that tau stays in registers
#pragma unroll
  for (int r = 0; r < LG_ND; ++r) {
    if (r >= nD) break;
    float sc, rv;
    if (r < 6) {
      sc = Ws[W_DYN];
      rv = tau[r].v * Ws[W_DYN] + lam[r];
    } else {
      const float t = tau[r].v;
      const float g = fabsf(t) - Ws[W_TLIM + r - 6], s = lami[20 + r - 6];
      const float sgn = t > 0.f ? 1.f : (t < 0.f ? -1.f : 0.f);
      sc = shifted_slope(g, s) * sgn * Ws[W_TORQUE];
      rv = shifted_value(g, s) * Ws[W_TORQUE];
    }
    S.D[r][d] = sc * tau[r].t;
    if (d == 18 + r)            // d tau_r / d f_k = -cnt d v_foot_k / d v_r
      for (int k = 0; k < 12; ++k) S.D[r][54 + k] = -sc * cnt[k / 3] * vf[k].t;
    if (res) {
      S.D[r][66] = rv;
      S.D[r][67] = sc;          // the mass kernel's raw M columns take it
    }
  }
  if (res) closed_forms(Ws, In, S);
}

__global__ void __launch_bounds__(ROWS_THREADS)
lingram_rows_kernel(const float* __restrict__ X, const float* __restrict__ U,
                    const float* __restrict__ Par, const float* __restrict__ consts,
                    const float* __restrict__ wts, NodeRows* __restrict__ rows, int BN,
                    int include_torque) {
  static_assert(ROWS_NODES * 36 <= ROWS_THREADS, "one thread per (node, direction)");
  constexpr int NT = ROWS_THREADS;
  __shared__ float Cs[N_CONSTS];
  __shared__ float Ws[N_WEIGHTS];
  __shared__ NodeIn in[ROWS_NODES];
  const int tid = threadIdx.x;
  const int node0 = blockIdx.x * ROWS_NODES;
  const int nodes = min(ROWS_NODES, BN - node0);     // the last block may be ragged
  const int nD = include_torque ? LG_ND : 6;
  for (int i = tid; i < N_CONSTS; i += NT) Cs[i] = consts[i];
  for (int i = tid; i < N_WEIGHTS; i += NT) Ws[i] = wts[i];
  for (int i = tid; i < nodes * N_NODE_PAR; i += NT)
    in[i / N_NODE_PAR].P[i % N_NODE_PAR] = Par[(size_t)node0 * N_NODE_PAR + i];
  for (int i = tid; i < nodes * 36; i += NT) in[i / 36].Z[i % 36] = X[(size_t)node0 * 36 + i];
  for (int i = tid; i < nodes * 30; i += NT)
    in[i / 30].Z[36 + i % 30] = U[(size_t)node0 * 30 + i];
  __syncthreads();
  if (tid < nodes * 36)
    direction_pass(Cs, Ws, in[tid / 36], rows[node0 + tid / 36], tid % 36, nD);
}

// Column j of M(q) = d tau / d a for MASS_NODES nodes a block, thread t <
// MASS_NODES*18 on column t % 18 of node t / 18: one values-only pass at
// unit acceleration a = e_j with v = 0, fe = 0 and gravity off, written
// unscaled into D's a columns (the Gram kernel applies the row scales).
__global__ void __launch_bounds__(MASS_THREADS)
lingram_mass_kernel(const float* __restrict__ X, const float* __restrict__ consts,
                    NodeRows* __restrict__ rows, int BN, int include_torque) {
  __shared__ float Cs[N_CONSTS];
  __shared__ float Qs[MASS_NODES][18];
  const int tid = threadIdx.x;
  const int node0 = blockIdx.x * MASS_NODES;
  const int nodes = min(MASS_NODES, BN - node0);
  const int nD = include_torque ? LG_ND : 6;
  for (int i = tid; i < N_CONSTS; i += MASS_THREADS) Cs[i] = consts[i];
  for (int i = tid; i < nodes * 18; i += MASS_THREADS)
    Qs[i / 18][i % 18] = X[(size_t)(node0 + i / 18) * 36 + i % 18];
  __syncthreads();
  if (tid >= nodes * 18) return;
  const int n = tid / 18, j = tid % 18;
  float q[18], z[18], a[18], fe[12], pf[12], vf[12], tau[18];
  for (int i = 0; i < 18; ++i) {
    q[i] = Qs[n][i];
    z[i] = 0.f;
    a[i] = i == j ? 1.f : 0.f;
  }
  for (int i = 0; i < 12; ++i) fe[i] = 0.f;
  body_pass<float>(Cs, q, z, a, fe, pf, vf, tau, 0.f);
  NodeRows& S = rows[node0 + n];
#pragma unroll
  for (int r = 0; r < LG_ND; ++r)
    if (r < nD) S.D[r][36 + j] = tau[r];
}

// s[a][b] += sum over n rows of A[r][i + a] * A[r][j + b] (i, j even)
template <int STRIDE>
__device__ __forceinline__ void tile_rows(const float* A, int n, int i, int j, float (&s)[2][2]) {
#pragma unroll 6
  for (int r = 0; r < n; ++r) {
    const float2 x = *reinterpret_cast<const float2*>(A + r * STRIDE + i);
    const float2 y = *reinterpret_cast<const float2*>(A + r * STRIDE + j);
    s[0][0] += x.x * y.x;
    s[0][1] += x.x * y.y;
    s[1][0] += x.y * y.x;
    s[1][1] += x.y * y.y;
  }
}

// s[a] += sum over n rows of A[r][i + a] * A[r][c] (i even)
template <int STRIDE>
__device__ __forceinline__ void tile_vec(const float* A, int n, int i, int c, float (&s)[2]) {
#pragma unroll 6
  for (int r = 0; r < n; ++r) {
    const float2 x = *reinterpret_cast<const float2*>(A + r * STRIDE + i);
    const float y = A[r * STRIDE + c];
    s[0] += x.x * y;
    s[1] += x.y * y;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// 2x2 tile t of node g's [Q | M | R | qx | ru] (qx and ru in 2x1 tiles).
__device__ void gram_tile(const NodeRows& S, const float* wT2, int t, int nD, size_t g,
                          float* Qo, float* Ro, float* Mo, float* qxo, float* ruo) {
  const float* D = &S.D[0][0];
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (t < 18 * 18) {
    const int i = 2 * (t / 18), j = 2 * (t % 18);
    tile_rows<68>(D, nD, i, j, s);
    tile_rows<38>(&S.Sp[0][0], LG_NP, i, j, s);
    if (i < 18 && j < 18) tile_rows<20>(&S.Sq[0][0], LG_NQ, i, j, s);
    if (i == j) {
      s[0][0] += wT2[i];
      s[1][1] += wT2[i + 1];
    }
    float* o = Qo + g * 1296 + i * 36 + j;
    store2(o, s[0][0], s[0][1]);
    store2(o + 36, s[1][0], s[1][1]);
    return;
  }
  t -= 18 * 18;
  if (t < 18 * 15) {
    const int i = 2 * (t / 15), k = 2 * (t % 15);
    tile_rows<68>(D, nD, i, 36 + k, s);
    float* o = Mo + g * 1080 + i * 30 + k;
    store2(o, s[0][0], s[0][1]);
    store2(o + 30, s[1][0], s[1][1]);
    return;
  }
  t -= 18 * 15;
  if (t < 15 * 15) {
    const int k = 2 * (t / 15), l = 2 * (t % 15);
    tile_rows<68>(D, nD, 36 + k, 36 + l, s);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int kk = k + a, ll = l + b;
        if (kk == ll) s[a][b] += S.Rd[kk];
        if (kk >= 18 && ll >= 18 && (kk - 18) / 3 == (ll - 18) / 3)
          s[a][b] += S.cone[(kk - 18) / 3][(kk - 18) % 3][(ll - 18) % 3];
      }
    float* o = Ro + g * 900 + k * 30 + l;
    store2(o, s[0][0], s[0][1]);
    store2(o + 30, s[1][0], s[1][1]);
    return;
  }
  t -= 15 * 15;
  float v[2] = {0.f, 0.f};
  if (t < 18) {
    const int i = 2 * t;
    tile_vec<68>(D, nD, i, 66, v);
    tile_vec<38>(&S.Sp[0][0], LG_NP, i, 36, v);
    if (i < 18) tile_vec<20>(&S.Sq[0][0], LG_NQ, i, 18, v);
    store2(qxo + g * 36 + i, v[0] + S.qx0[i], v[1] + S.qx0[i + 1]);
    return;
  }
  const int k = 2 * (t - 18);
  tile_vec<68>(D, nD, 36 + k, 66, v);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    v[a] += S.ru0[k + a];
    if (k + a >= 18) v[a] += S.cone[(k + a - 18) / 3][(k + a - 18) % 3][3];
  }
  store2(ruo + g * 30 + k, v[0], v[1]);
}

__global__ void __launch_bounds__(GN_THREADS)
lingram_gram_kernel(const NodeRows* __restrict__ rows, const float* __restrict__ wts,
                    float* __restrict__ Qo, float* __restrict__ Ro, float* __restrict__ Mo,
                    float* __restrict__ qxo, float* __restrict__ ruo, int BN,
                    int include_torque) {
  __shared__ NodeRows S[GN_NODES];
  __shared__ float wT2[36];
  const int tid = threadIdx.x;
  const int node0 = blockIdx.x * GN_NODES;
  const int nodes = min(GN_NODES, BN - node0);
  const int nD = include_torque ? LG_ND : 6;
  const float4* src = reinterpret_cast<const float4*>(rows + node0);
  float4* dst = reinterpret_cast<float4*>(S);
  const int n4 = nodes * (int)(sizeof(NodeRows) / 16);
  for (int i = tid; i < n4; i += GN_THREADS) dst[i] = src[i];
  __syncthreads();
  for (int i = tid; i < nodes * nD * 18; i += GN_THREADS) {
    const int n = i / (nD * 18), r = (i / 18) % nD;
    S[n].D[r][36 + i % 18] *= S[n].D[r][67];     // M's rows, scaled
  }
  if (tid < 36) {
    // x order: base pos 6, joint pos 12, base vel 6, joint vel 12
    const float w = tid < 6 ? wts[W_BASE + tid]
                  : tid < 18 ? wts[W_JOINT + tid - 6]
                  : tid < 24 ? wts[W_BASE + tid - 12] : wts[W_JOINT + tid - 12];
    wT2[tid] = w * w;
  }
  __syncthreads();
  for (int idx = tid; idx < nodes * LG_TILES; idx += GN_THREADS) {
    const int n = idx / LG_TILES;
    gram_tile(S[n], wT2, idx - n * LG_TILES, nD, (size_t)(node0 + n), Qo, Ro, Mo, qxo, ruo);
  }
}

// Floats per node of the row buffer that lingram_launch takes.
extern "C" int lingram_row_floats() { return (int)(sizeof(NodeRows) / sizeof(float)); }

// The compiled kernels' registers per thread and local memory per thread
// (stack frame and spills), rows, mass and Gram kernel in turn: out[0..5]
// = (registers, local bytes) x 3.
extern "C" int lingram_attributes(int* out) {
  const void* fns[3] = {(const void*)lingram_rows_kernel, (const void*)lingram_mass_kernel,
                        (const void*)lingram_gram_kernel};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return (int)err;
    out[2 * k] = a.numRegs;
    out[2 * k + 1] = (int)a.localSizeBytes;
  }
  return 0;
}

// rows: BN * lingram_row_floats() floats of scratch, 16-byte aligned.
extern "C" int lingram_launch(const float* X, const float* U, const float* Par,
                              const float* consts, const float* wts, float* rows, float* Q,
                              float* R, float* M, float* qx, float* ru, int BN,
                              int include_torque, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  NodeRows* nr = reinterpret_cast<NodeRows*>(rows);
  lingram_rows_kernel<<<(BN + ROWS_NODES - 1) / ROWS_NODES, ROWS_THREADS, 0, st>>>(
      X, U, Par, consts, wts, nr, BN, include_torque);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  lingram_mass_kernel<<<(BN + MASS_NODES - 1) / MASS_NODES, MASS_THREADS, 0, st>>>(
      X, consts, nr, BN, include_torque);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  lingram_gram_kernel<<<(BN + GN_NODES - 1) / GN_NODES, GN_THREADS, 0, st>>>(
      nr, wts, Q, R, M, qx, ru, BN, include_torque);
  return (int)cudaGetLastError();
}
