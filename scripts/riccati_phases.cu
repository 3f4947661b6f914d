// The Riccati node stage's phases (csrc/riccati.cuh), each timed alone on
// one block of RIC_THREADS threads with clock64(): the factor warp's Quu row
// and factorization, the column threads' forward and backward solves, the
// tile threads' Qxx and Qux and value update; then the factor beside the
// other roles' phase-1 work; then single-warp latencies of dependent
// chains. Two baselines of the factorization broadcast each pivot's column
// with __shfl_sync (one shuffle a column entry) instead of through shared
// memory: rolled as the shipped loops are, and fully unrolled.
//
// Built and run by scripts/bench_riccati_phases.py (nvcc, this checkout's
// flags); prints one line per measurement, median cycles over REPS - 1
// repetitions after the first.
#include <algorithm>
#include <cstdio>
#include <vector>

#include "riccati.cuh"

extern __shared__ __align__(16) unsigned char rp_smem[];
#define REPS 26

__device__ __forceinline__ long long tick() {
  __syncwarp();
  return clock64();
}

// ---- baselines: the column broadcast by shuffles ----
template <int J>
__device__ __forceinline__ void shfl_pivot(float (&a)[NU], int lane, int k, float& d, float& myr,
                                           RicSmem& s) {
  const unsigned full = 0xffffffffu;
  const float r = rsqrtf(fmaxf(d, 1e-30f));
  if (lane == k) myr = r;
  const float lk = a[0] * r;
  if (lane > k && lane < NU) {
    s.Lf[k][lane - k - 1] = lk;
    s.Lb[0][lane][k + NU - 1 - lane] = lk;
  }
  d = __shfl_sync(full, fmaf(-lk, lk, a[1]), k + 1);
#pragma unroll
  for (int j = 0; j < J; ++j) a[j] = fmaf(-lk, __shfl_sync(full, lk, k + 1 + j), a[j + 1]);
}

__device__ __forceinline__ void shfl_factor_rolled(float (&a)[NU], int lane, RicSmem& s) {
  float myr = 0.f;
  float d = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll 1
  for (int k = 0; k < 10; ++k) shfl_pivot<NU - 1>(a, lane, k, d, myr, s);
#pragma unroll 1
  for (int k = 10; k < 20; ++k) shfl_pivot<NU - 11>(a, lane, k, d, myr, s);
#pragma unroll 1
  for (int k = 20; k < NU; ++k) shfl_pivot<NU - 21>(a, lane, k, d, myr, s);
  if (lane < NU) s.rs[0][lane] = myr;
}

// lane i keeps row i in place (a[j] = column j), every pivot unrolled
__device__ __forceinline__ void shfl_factor_unrolled(float (&a)[NU], int lane, RicSmem& s) {
  const unsigned full = 0xffffffffu;
  float myr = 0.f;
  float d = __shfl_sync(full, a[0], 0);
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const float r = rsqrtf(fmaxf(d, 1e-30f));
    if (lane == k) myr = r;
    const float lk = a[k] * r;
    a[k] = lk;
    if (k + 1 < NU) {
      d = __shfl_sync(full, fmaf(-lk, lk, a[k + 1]), k + 1);
#pragma unroll
      for (int j = k + 1; j < NU; ++j) a[j] = fmaf(-lk, __shfl_sync(full, lk, j), a[j]);
    }
  }
  if (lane < NU) s.rs[0][lane] = myr;
}

// a node's inputs: P = I + small symmetric, R = 4 I + small symmetric
__device__ void fill(RicSmem& s, int tid) {
  for (int e = tid; e < NX * NX; e += blockDim.x) {
    const int i = e / NX, j = e % NX;
    s.P[i][j] = (i == j ? 1.f : 0.f) + 0.01f * __sinf(0.3f * (i + j));
  }
  for (int e = tid; e < NU * NU; e += blockDim.x) {
    const int i = e / NU, j = e % NU;
    s.in[0][RB_R + e] = (i == j ? 4.f : 0.f) + 0.1f * __cosf(0.7f * (i + j));
  }
  for (int e = tid; e < NU * NW; e += blockDim.x) s.Wm[e / NW][e % NW] = __sinf(0.1f * e);
  for (int e = tid; e < NX * NX; e += blockDim.x) s.in[0][RB_Q + e] = __cosf(0.05f * e);
  for (int e = tid; e < NX * NU; e += blockDim.x) s.in[0][RB_M + e] = __sinf(0.07f * e);
  for (int i = tid; i < NX; i += blockDim.x) s.qxp[i] = 0.1f * i;
  __syncthreads();
}

// V: 0 the shipped factorization, 1 rolled shuffles, 2 unrolled shuffles
template <int V>
__global__ void __launch_bounds__(RIC_THREADS, 4) factor_kernel(long long* out, float* sink) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(rp_smem);
  const int tid = threadIdx.x, lane = tid & 31;
  fill(s, tid);
  if (tid >= 32) return;
  float a[NU];
  for (int it = 0; it < REPS; ++it) {
    const long long t0 = tick();
    ric_quu_row(s.in[0] + RB_R, s.P, 0.02f, 1e-6f, lane, a);
    const long long t1 = tick();
    if (V == 0) ric_factor(a, lane, s.Lf, s.Lb[0], s.rs[0], s.dg);
    if (V == 1) shfl_factor_rolled(a, lane, s);
    if (V == 2) shfl_factor_unrolled(a, lane, s);
    const long long t2 = tick();
    if (lane == 0) {
      out[2 * it] = t1 - t0;
      out[2 * it + 1] = t2 - t1;
    }
  }
  if (lane < NU) sink[lane] = s.rs[0][lane] + a[0];
}

__global__ void __launch_bounds__(RIC_THREADS, 4) solve_kernel(long long* out, float* G) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(rp_smem);
  __shared__ float W0[NU][NW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, c = tid - RIC_COL0;
  fill(s, tid);
  for (int e = tid; e < NU * NW; e += blockDim.x) W0[e / NW][e % NW] = s.Wm[e / NW][e % NW];
  if (warp == 0) {
    float a[NU];
    ric_quu_row(s.in[0] + RB_R, s.P, 0.02f, 1e-6f, lane, a);
    ric_factor(a, lane, s.Lf, s.Lb[0], s.rs[0], s.dg);
  }
  __syncthreads();
  if (warp < 1 || warp > 2) return;
  float b[NU];
  for (int it = 0; it < REPS; ++it) {
    if (c < NW)
      for (int k = 0; k < NU; ++k) s.Wm[k][c] = W0[k][c];
    const long long t0 = tick();
    if (c < NW) ric_forward(b, c, s.Wm, s.Lf, s.rs[0]);
    const long long t1 = tick();
    if (c < NW) ric_backward(b, c, s.Lb[0], s.rs[0], G);
    const long long t2 = tick();
    if (c == 0) {
      out[2 * it] = t1 - t0;
      out[2 * it + 1] = t2 - t1;
    }
  }
}

__global__ void __launch_bounds__(RIC_THREADS, 4) tiles_kernel(long long* out, float*) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(rp_smem);
  const int tid = threadIdx.x, warp = tid >> 5, t = tid - RIC_TILE0;
  fill(s, tid);
  if (warp < 3) return;
  int ti = 0, tj = 0;
  if (t < RIC_TILES) ric_tile_of(t, ti, tj);
  float v[NU];
  for (int it = 0; it < REPS; ++it) {
    const long long t0 = tick();
    if (t < RIC_TILES) ric_qxx_tile(s.in[0] + RB_Q, s.P, 0.02f, ti, tj, v);
    ric_qux(s.in[0] + RB_M, s.P, 0.02f, t, s.Wm);
    const long long t1 = tick();
    if (t < RIC_TILES) ric_value_tile(v, v, ti, tj, s.Wm, s.P);
    const long long t2 = tick();
    if (t == 0) {
      out[2 * it] = t1 - t0;
      out[2 * it + 1] = t2 - t1;
    }
  }
}

// phase 1 with every role at work (ALL) or the factor warp alone: the
// factor warp's Quu row and factorization
template <bool ALL>
__global__ void __launch_bounds__(RIC_THREADS, 4) phase1_kernel(long long* out, float* G) {
  RicSmem& s = *reinterpret_cast<RicSmem*>(rp_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid - RIC_COL0, t = tid - RIC_TILE0;
  fill(s, tid);
  int ti = 0, tj = 0;
  if (warp >= 3 && t < RIC_TILES) ric_tile_of(t, ti, tj);
  float v[NU];
  for (int k = 0; k < NU; ++k) v[k] = 0.01f * k;
  for (int it = 0; it < REPS; ++it) {
    __syncthreads();
    const long long t0 = tick();
    if (warp == 0) {
      ric_quu_row(s.in[0] + RB_R, s.P, 0.02f, 1e-6f, lane, v);
      ric_factor(v, lane, s.Lf, s.Lb[it & 1], s.rs[it & 1], s.dg);
    } else if (ALL && warp < 3) {
      if (c < NW) ric_backward(v, c, s.Lb[(it + 1) & 1], s.rs[(it + 1) & 1], G);
    } else if (ALL) {
      if (t < RIC_TILES) ric_qxx_tile(s.in[0] + RB_Q, s.P, 0.02f, ti, tj, v);
      ric_qux(s.in[0] + RB_M, s.P, 0.02f, t, s.Wm);
    }
    const long long t1 = tick();
    if (tid == 0) {
      out[2 * it] = t1 - t0;
      out[2 * it + 1] = 0;
    }
  }
  if (lane < NU) G[2048 + tid] = v[0];
}

// single-warp dependent chains, 64 steps each, in rolled loops
__global__ void latency_kernel(long long* out, float* sink) {
  __shared__ float buf[32];
  const int lane = threadIdx.x;
  buf[lane] = lane;
  __syncwarp();
  float x = lane;
  const long long t0 = tick();
#pragma unroll 1
  for (int i = 0; i < 64; ++i) x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31) + 1.f;
  const long long t1 = tick();
  int idx = lane;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) idx = (int)buf[idx & 31] & 31;
  const long long t2 = tick();
  float y = 1.f;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) y = rsqrtf(y + 1.f);
  const long long t3 = tick();
  float z = x;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) z = fmaf(z, 0.999f, 0.5f);
  const long long t4 = tick();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
  }
  sink[lane] = x + idx + y + z;
}

static double median_after_first(const std::vector<long long>& h, int col) {
  std::vector<long long> v;
  for (int i = 1; i < REPS; ++i) v.push_back(h[2 * i + col]);
  std::sort(v.begin(), v.end());
  return (double)v[v.size() / 2];
}

template <class K>
static int run(const char* name, const char* a, const char* b, K kernel, long long* d_out,
               float* d_sink) {
  const int smem = sizeof(RicSmem);
  cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<1, RIC_THREADS, smem>>>(d_out, d_sink);
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("%s: %s\n", name, cudaGetErrorString(err));
    return 1;
  }
  std::vector<long long> h(2 * REPS);
  cudaMemcpy(h.data(), d_out, 2 * REPS * 8, cudaMemcpyDeviceToHost);
  printf("%s: %s %.0f", name, a, median_after_first(h, 0));
  if (b) printf(", %s %.0f", b, median_after_first(h, 1));
  printf(" cycles\n");
  return 0;
}

int main() {
  long long* d_out;
  float* d_sink;
  cudaMalloc(&d_out, 4096 * 8);
  cudaMalloc(&d_sink, 64 * 1024 * 4);
  int bad = 0;
  bad |= run("factor warp, shipped", "quu", "factor", factor_kernel<0>, d_out, d_sink);
  bad |= run("factor warp, rolled shuffles", "quu", "factor", factor_kernel<1>, d_out, d_sink);
  bad |= run("factor warp, unrolled shuffles", "quu", "factor", factor_kernel<2>, d_out, d_sink);
  bad |= run("column threads", "forward", "backward", solve_kernel, d_out, d_sink);
  bad |= run("tile threads", "Qxx + Qux", "value update", tiles_kernel, d_out, d_sink);
  bad |= run("phase 1, factor warp alone", "quu + factor", nullptr, phase1_kernel<false>, d_out,
             d_sink);
  bad |= run("phase 1, every role at work", "quu + factor", nullptr, phase1_kernel<true>, d_out,
             d_sink);
  latency_kernel<<<1, 32>>>(d_out, d_sink);
  cudaDeviceSynchronize();
  long long h[4];
  cudaMemcpy(h, d_out, 32, cudaMemcpyDeviceToHost);
  printf("one warp, a step of a dependent chain in a rolled loop: shfl + fadd %.1f, lds %.1f, "
         "rsqrt + fadd %.1f, ffma %.1f cycles\n",
         h[0] / 64.0, h[1] / 64.0, h[2] / 64.0, h[3] / 64.0);
  return bad;
}
