// policy_pd: the learned policy's batched serving step, fused. For B
// environments, the BatchNorm-folded MLP n_in -> h1 -> h2 -> h3 -> n_out
// (ReLU after the three hidden layers) and the joint PD torque:
//   act = relu(relu(relu(x W1 + b1) W2 + b2) W3 + b3) W4 + b4
//   tau = kp (act - qj) - kd vj
// x (B, n_in), qj, vj (B, n_out), W_l (d_in, d_out) row-major, fp32.
//
// Replaces iterative_learning_nmpc_tpu/ops/policy_kernel.py
// make_fused_policy_pd (_policy_pd_kernel), fp32 compute_dtype.
//
// Bound on this card: fp32 FMA throughput (2 B (n_in h + 2 h^2 + h n_out)
// flops, 2.8e8 at B = 256 for the 47 -> 512x3 -> 12 net) against 2.3 MB of
// weights. The TPU kernel keeps all weights in VMEM; here they do not fit
// in a block's shared memory, so each block streams them from global
// memory (where they stay in the 50 MB L2 across blocks) in tiles of
// PP_KT rows, through a PP_STAGES-deep cp.async ring in shared memory, so
// that the loads of the next tiles overlap the FMAs on the current one and
// each weight is fetched once per block. Design: one block of 128 threads
// per tile of 8 rows (B = 256 gives 32 blocks); the tile's activations stay
// in shared memory across the four layers, transposed (k-major, 8 floats
// per k) and double-buffered. Thread (row group g = t / 64, lane
// l = t % 64) accumulates rows 4g..4g+3 times columns 4l..4l+3 and
// 256+4l..256+4l+3 of each 512-column pass: per k one broadcast float4 of
// activations and two conflict-free float4 of weights feed 32 FMAs. The PD
// epilogue is the last layer's. Rows past B (the ragged last tile) read
// zeros and write nothing. Every layer width must be a multiple of 4 and
// the weights 16-byte aligned (checked by the wrapper).
#include <cuda_runtime.h>

#define PP_TM 8          // rows (environments) per block
#define PP_THREADS 128   // 2 row groups x 64 column lanes
#define PP_RPT 4         // rows per thread
#define PP_CW 512        // columns per pass: 64 lanes x 2 float4
#define PP_KT 8          // weight rows per staged tile
#define PP_STAGES 3      // tiles in flight

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PP_STAGES - 2));
}

// Stage weight rows k0 .. k0+PP_KT-1 (those < K), columns n0 .. n0+nw-1 of
// W (K x N) into sw (PP_KT x PP_CW).
__device__ __forceinline__ void load_tile(float* sw, const float* __restrict__ W,
                                          int K, int N, int k0, int n0, int nw) {
  const int per_row = nw >> 2;
  const int rows = min(PP_KT, K - k0);
  for (int i = threadIdx.x; i < rows * per_row; i += PP_THREADS) {
    const int kk = i / per_row, c = (i - kk * per_row) << 2;
    cp_async16(sw + kk * PP_CW + c, W + (size_t)(k0 + kk) * N + n0 + c);
  }
}

// One layer for the block's rows: hin (K x PP_TM, k-major, shared) times
// W (K x N, global, staged through ring) plus b. Hidden layers write
// relu(.) to hout (N x PP_TM, shared); the last layer writes act and the PD
// torque to global memory.
template <bool LAST>
__device__ __forceinline__ void dense_tile(
    const float* __restrict__ hin, int K, const float* __restrict__ W,
    const float* __restrict__ bias, int N, float* __restrict__ hout,
    float* __restrict__ ring, int row0, int B, const float* __restrict__ qj,
    const float* __restrict__ vj, float kp, float kd, float* __restrict__ act,
    float* __restrict__ tau) {
  const int lane = threadIdx.x & 63;
  const int r0 = (threadIdx.x >> 6) * PP_RPT;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nk = (K + PP_KT - 1) / PP_KT;
  for (int n0 = 0; n0 < N; n0 += PP_CW) {
    const int nw = min(PP_CW, N - n0);
    const bool okA = 4 * lane < nw, okB = 256 + 4 * lane < nw;
    float acc[PP_RPT][8];
#pragma unroll
    for (int i = 0; i < PP_RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // prologue: the first PP_STAGES - 1 tiles (one commit group each)
#pragma unroll
    for (int s = 0; s < PP_STAGES - 1; ++s) {
      if (s < nk) load_tile(ring + s * PP_KT * PP_CW, W, K, N, s * PP_KT, n0, nw);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      cp_async_wait_prior();   // tile t has landed (this thread's copies)
      __syncthreads();         // ... everyone's; tile t-1's slot is free
      const int tn = t + PP_STAGES - 1;
      if (tn < nk)
        load_tile(ring + (tn % PP_STAGES) * PP_KT * PP_CW, W, K, N, tn * PP_KT, n0, nw);
      cp_async_commit();
      const float* sw = ring + (t % PP_STAGES) * PP_KT * PP_CW;
      const int k0 = t * PP_KT, kn = min(PP_KT, K - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4 h = *reinterpret_cast<const float4*>(hin + (k0 + kk) * PP_TM + r0);
        const float4 wa = okA ? *reinterpret_cast<const float4*>(sw + kk * PP_CW + 4 * lane) : zero;
        const float4 wb =
            okB ? *reinterpret_cast<const float4*>(sw + kk * PP_CW + 256 + 4 * lane) : zero;
        const float hv[PP_RPT] = {h.x, h.y, h.z, h.w};
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < PP_RPT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();           // the ring is free for the next pass or layer
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * lane : 256 + 4 * lane) + (j & 3);
      if (n >= N) continue;
      const float bn = bias[n];
      if (!LAST) {
        *reinterpret_cast<float4*>(hout + n * PP_TM + r0) =
            make_float4(fmaxf(acc[0][j] + bn, 0.f), fmaxf(acc[1][j] + bn, 0.f),
                        fmaxf(acc[2][j] + bn, 0.f), fmaxf(acc[3][j] + bn, 0.f));
      } else {
#pragma unroll
        for (int i = 0; i < PP_RPT; ++i) {
          const int row = row0 + r0 + i;
          if (row >= B) continue;
          const size_t o = (size_t)row * N + n;
          const float a = acc[i][j] + bn;
          act[o] = a;
          tau[o] = kp * (a - qj[o]) - kd * vj[o];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(PP_THREADS)
policy_pd_kernel(const float* __restrict__ x, const float* __restrict__ qj,
                 const float* __restrict__ vj, const float* __restrict__ W1,
                 const float* __restrict__ b1, const float* __restrict__ W2,
                 const float* __restrict__ b2, const float* __restrict__ W3,
                 const float* __restrict__ b3, const float* __restrict__ W4,
                 const float* __restrict__ b4, float* __restrict__ act,
                 float* __restrict__ tau, int B, int n_in, int h1, int h2,
                 int h3, int n_out, int dmax, float kp, float kd) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                   // PP_STAGES x PP_KT x PP_CW
  float* hA = ring + PP_STAGES * PP_KT * PP_CW;
  float* hB = hA + (size_t)dmax * PP_TM;
  const int row0 = blockIdx.x * PP_TM;
  for (int i = threadIdx.x; i < PP_TM * n_in; i += PP_THREADS) {
    const int m = i / n_in, k = i - m * n_in;
    const int row = row0 + m;
    hA[k * PP_TM + m] = row < B ? x[(size_t)row * n_in + k] : 0.f;
  }
  __syncthreads();
  dense_tile<false>(hA, n_in, W1, b1, h1, hB, ring, row0, B, qj, vj, kp, kd, act, tau);
  __syncthreads();
  dense_tile<false>(hB, h1, W2, b2, h2, hA, ring, row0, B, qj, vj, kp, kd, act, tau);
  __syncthreads();
  dense_tile<false>(hA, h2, W3, b3, h3, hB, ring, row0, B, qj, vj, kp, kd, act, tau);
  __syncthreads();
  dense_tile<true>(hB, h3, W4, b4, n_out, nullptr, ring, row0, B, qj, vj, kp, kd, act,
                   tau);
}

extern "C" int policy_pd_launch(const float* x, const float* qj, const float* vj,
                                const float* W1, const float* b1, const float* W2,
                                const float* b2, const float* W3, const float* b3,
                                const float* W4, const float* b4, float* act,
                                float* tau, int B, int n_in, int h1, int h2,
                                int h3, int n_out, float kp, float kd,
                                void* stream) {
  int dmax = n_in;
  if (h1 > dmax) dmax = h1;
  if (h2 > dmax) dmax = h2;
  if (h3 > dmax) dmax = h3;
  const int smem =
      (PP_STAGES * PP_KT * PP_CW + 2 * dmax * PP_TM) * (int)sizeof(float);
  // the largest dynamic shared memory allowed so far, per device
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(policy_pd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  const int grid = (B + PP_TM - 1) / PP_TM;
  policy_pd_kernel<<<grid, PP_THREADS, smem, (cudaStream_t)stream>>>(
      x, qj, vj, W1, b1, W2, b2, W3, b3, W4, b4, act, tau, B, n_in, h1, h2,
      h3, n_out, dmax, kp, kd);
  return (int)cudaGetLastError();
}
