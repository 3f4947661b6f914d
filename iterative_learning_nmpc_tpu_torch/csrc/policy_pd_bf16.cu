// policy_pd_bf16: the learned policy's batched serving step with bf16
// products on the tensor cores. For B environments, the BatchNorm-folded
// MLP n_in -> h1 -> h2 -> h3 -> n_out (ReLU after the hidden layers) and
// the joint PD torque:
//   h1  = relu(x W1 + b1)                          fp32 (K = n_in = 47)
//   h2  = relu(bf16(h1) W2 + b2), h3 likewise      bf16 x bf16 -> fp32 sums
//   act = bf16(h3) W4 + b4,  tau = kp (act - qj) - kd vj          fp32
// x (B, n_in), qj, vj (B, n_out) fp32; W1 (n_in, h1) fp32 row-major; W2
// (h1, h2), W3 (h2, h3), W4 (h3, 16) bf16 row-major (W4 padded with zero
// columns past n_out <= 16); biases fp32 (b4 has n_out entries).
//
// Replaces iterative_learning_nmpc_tpu/ops/policy_kernel.py
// make_fused_policy_pd (_policy_pd_kernel) with compute_dtype=bfloat16:
// activations are rounded to bf16 (round to nearest even) where the TPU
// kernel casts them, at the inputs of layers 2-4 after the fp32 bias and
// ReLU; the weights were rounded once by the factory (ops/policy_pd.py).
//
// Bound on this card: layers 2-4 are 2 B (h1 h2 + h2 h3 + h3 n_out) flops on
// the bf16 tensor cores (989 TFLOP/s dense), layer 1 2 B n_in h1 on the fp32
// cores (67 TFLOP/s), against about 1.2 MB of weights (3.35 TB/s, and the
// weights stay in the 50 MB L2): well under a microsecond at B = 256, so
// latency and occupancy, not the roof, set the time. Design: one block of
// 4 warps per tile of 16 rows, the mma's M (B = 256 gives 16 blocks). The
// tile's activations stay in shared memory across the layers as bf16 rows
// padded by 8 (conflict-free A fragments). Layer 1: each thread owns 4
// columns of all 16 rows, one float4 of W1 per k. Layers 2-4: mma.sync
// m16n8k16 (bf16 in, fp32 accumulate); the weights stream from global
// memory (L2) through a PB_STAGES-deep cp.async ring of PB_KT-row tiles
// (32 KB each), so that the next tiles' loads overlap the products on the
// current one (a first version, which read its B fragments straight from
// global memory, waited on one L2 round trip per 16 rows of K); each warp
// owns 128 output columns (16 n-tiles of 8) per pass, reads its A fragments
// from shared memory and its B fragments with ldmatrix.trans, and applies
// bias, ReLU and the bf16 rounding in its epilogue. Rows past B read zeros
// and write nothing; columns past n_out are never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PB_TM 16         // rows per block: the mma's M
#define PB_WARPS 4
#define PB_THREADS (32 * PB_WARPS)
#define PB_NT 16         // n-tiles (8 columns each) per warp and pass
#define PB_CW (PB_WARPS * 8 * PB_NT)   // columns per pass: 512
#define PB_PAD 8         // bf16 padding of an activation row and of a ring row
#define PB_KT 32         // weight rows per staged tile
#define PB_STAGES 4      // tiles in the ring
#define PB_LDW (PB_CW + PB_PAD)         // ring row stride: conflict-free ldmatrix

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Layer 1 in fp32: hout (PB_TM x ldo, bf16) = bf16(relu(xs W1 + b1)).
__device__ __forceinline__ void dense_fp32(const float* __restrict__ xs, int n_in,
                                           const float* __restrict__ W1,
                                           const float* __restrict__ b1, int h1,
                                           __nv_bfloat16* __restrict__ hout, int ldo) {
  for (int n0 = 4 * threadIdx.x; n0 < h1; n0 += 4 * PB_THREADS) {
    float acc[PB_TM][4];
#pragma unroll
    for (int r = 0; r < PB_TM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_in; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(W1 + (size_t)k * h1 + n0));
#pragma unroll
      for (int r = 0; r < PB_TM; ++r) {
        const float xv = xs[r * n_in + k];
        acc[r][0] = fmaf(xv, w.x, acc[r][0]);
        acc[r][1] = fmaf(xv, w.y, acc[r][1]);
        acc[r][2] = fmaf(xv, w.z, acc[r][2]);
        acc[r][3] = fmaf(xv, w.w, acc[r][3]);
      }
    }
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b1 + n0));
#pragma unroll
    for (int r = 0; r < PB_TM; ++r) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(hout + r * ldo + n0);
      o[0] = __floats2bfloat162_rn(fmaxf(acc[r][0] + bb.x, 0.f), fmaxf(acc[r][1] + bb.y, 0.f));
      o[1] = __floats2bfloat162_rn(fmaxf(acc[r][2] + bb.z, 0.f), fmaxf(acc[r][3] + bb.w, 0.f));
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PB_STAGES - 2));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// four 8x8 bf16 matrices of a row-major smem tile, transposed: the B
// registers (k halves 0 and 1) of two neighbouring n-tiles. Lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sa)
               : "memory");
}

// Stage weight rows k0 .. k0+PB_KT-1 (those < K), columns n0 .. n0+nw-1 of
// W (K x N, bf16) into sw (PB_KT x PB_LDW), 16 bytes per cp.async.
__device__ __forceinline__ void load_tile(__nv_bfloat16* sw, const __nv_bfloat16* __restrict__ W,
                                          int K, int N, int k0, int n0, int nw) {
  const int per_row = nw >> 3;
  const int rows = min(PB_KT, K - k0);
  for (int i = threadIdx.x; i < rows * per_row; i += PB_THREADS) {
    const int kk = i / per_row, c = (i - kk * per_row) << 3;
    cp_async16(sw + kk * PB_LDW + c, W + (size_t)(k0 + kk) * N + n0 + c);
  }
}

// One tensor-core layer: hin (PB_TM x K, bf16, row stride K + PB_PAD) times
// W (K x N, bf16, global, streamed through the ring in tiles of PB_KT rows
// by up to PB_CW columns) plus bias. Hidden layers write bf16(relu(.)) to
// hout; the last writes act and the PD torque for its n_out columns and
// rows < B.
template <bool LAST>
__device__ __forceinline__ void dense_mma(const __nv_bfloat16* __restrict__ hin, int K,
                                          const __nv_bfloat16* __restrict__ W,
                                          const float* __restrict__ bias, int N,
                                          __nv_bfloat16* __restrict__ hout,
                                          __nv_bfloat16* __restrict__ ring, int row0, int B,
                                          int n_out, const float* __restrict__ qj,
                                          const float* __restrict__ vj, float kp, float kd,
                                          float* __restrict__ act, float* __restrict__ tau) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lda = K + PB_PAD, ldo = N + PB_PAD;
  const int nk = (K + PB_KT - 1) / PB_KT;
  // this lane's row address for ldmatrix: matrix q = lane / 8 covers k rows
  // (q & 1) * 8 .. + 7 and n columns (q >> 1) * 8 .. + 7 of a 16 x 16 block
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8, lm_col = (lane >> 4) * 8;
  for (int n0 = 0; n0 < N; n0 += PB_CW) {
    const int nw = min(PB_CW, N - n0);
    const int wn0 = warp * 8 * PB_NT;                 // the warp's columns in the pass
    const int ntiles = max(0, min(PB_NT, (nw - wn0) >> 3));   // even: nw % 16 == 0
    float acc[PB_NT][4];
#pragma unroll
    for (int j = 0; j < PB_NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    // prologue: the first PB_STAGES - 1 tiles, one commit group each
#pragma unroll
    for (int s = 0; s < PB_STAGES - 1; ++s) {
      if (s < nk) load_tile(ring + s * PB_KT * PB_LDW, W, K, N, s * PB_KT, n0, nw);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait_prior();   // tile kt has landed (this thread's copies)
      __syncthreads();         // ... everyone's; tile kt-1's slot is free
      const int tn = kt + PB_STAGES - 1;
      if (tn < nk)
        load_tile(ring + (tn % PB_STAGES) * PB_KT * PB_LDW, W, K, N, tn * PB_KT, n0, nw);
      cp_async_commit();
      const __nv_bfloat16* sw = ring + (kt % PB_STAGES) * PB_KT * PB_LDW;
      const int kn = min(PB_KT, K - kt * PB_KT);
#pragma unroll
      for (int kk = 0; kk < PB_KT; kk += 16) {
        if (kk >= kn) break;
        const __nv_bfloat16* ar = hin + g * lda + kt * PB_KT + kk + 2 * t;
        const uint32_t a0 = lds32(ar), a1 = lds32(ar + 8 * lda);
        const uint32_t a2 = lds32(ar + 8), a3 = lds32(ar + 8 * lda + 8);
        const __nv_bfloat16* bw = sw + (kk + lm_row) * PB_LDW + wn0 + lm_col;
#pragma unroll
        for (int j = 0; j < PB_NT; j += 2) {
          if (j < ntiles) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bw + 8 * j);
            mma_bf16_16816(acc[j], a0, a1, a2, a3, b[0], b[1]);
            mma_bf16_16816(acc[j + 1], a0, a1, a2, a3, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();           // the ring is free for the next pass or layer
    // acc[j]: rows g (0, 1) and g + 8 (2, 3), columns n0 + wn0 + 8 j + 2 t + (0, 1)
#pragma unroll
    for (int j = 0; j < PB_NT; ++j) {
      if (j >= ntiles) continue;
      const int n = n0 + wn0 + 8 * j + 2 * t;
      if (!LAST) {
        const float c0 = bias[n], c1 = bias[n + 1];
        *reinterpret_cast<__nv_bfloat162*>(hout + g * ldo + n) = __floats2bfloat162_rn(
            fmaxf(acc[j][0] + c0, 0.f), fmaxf(acc[j][1] + c1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(hout + (g + 8) * ldo + n) = __floats2bfloat162_rn(
            fmaxf(acc[j][2] + c0, 0.f), fmaxf(acc[j][3] + c1, 0.f));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + g + (i >> 1) * 8, col = n + (i & 1);
          if (row >= B || col >= n_out) continue;
          const size_t o = (size_t)row * n_out + col;
          const float a = acc[j][i] + bias[col];
          act[o] = a;
          tau[o] = kp * (a - qj[o]) - kd * vj[o];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(PB_THREADS)
policy_pd_bf16_kernel(const float* __restrict__ x, const float* __restrict__ qj,
                      const float* __restrict__ vj, const float* __restrict__ W1,
                      const float* __restrict__ b1, const __nv_bfloat16* __restrict__ W2,
                      const float* __restrict__ b2, const __nv_bfloat16* __restrict__ W3,
                      const float* __restrict__ b3, const __nv_bfloat16* __restrict__ W4,
                      const float* __restrict__ b4, float* __restrict__ act,
                      float* __restrict__ tau, int B, int n_in, int h1, int h2, int h3,
                      int n4, int n_out, int dmax, float kp, float kd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // PB_STAGES x PB_KT x PB_LDW
  __nv_bfloat16* hA = ring + PB_STAGES * PB_KT * PB_LDW;
  __nv_bfloat16* hB = hA + PB_TM * (dmax + PB_PAD);
  float* xs = reinterpret_cast<float*>(hB + PB_TM * (dmax + PB_PAD));   // PB_TM x n_in
  const int row0 = blockIdx.x * PB_TM;
  for (int i = threadIdx.x; i < PB_TM * n_in; i += PB_THREADS) {
    const int row = row0 + i / n_in;
    xs[i] = row < B ? x[(size_t)row0 * n_in + i] : 0.f;
  }
  __syncthreads();
  dense_fp32(xs, n_in, W1, b1, h1, hA, h1 + PB_PAD);
  __syncthreads();
  dense_mma<false>(hA, h1, W2, b2, h2, hB, ring, row0, B, n_out, qj, vj, kp, kd, act, tau);
  __syncthreads();
  dense_mma<false>(hB, h2, W3, b3, h3, hA, ring, row0, B, n_out, qj, vj, kp, kd, act, tau);
  __syncthreads();
  dense_mma<true>(hA, h3, W4, b4, n4, nullptr, ring, row0, B, n_out, qj, vj, kp, kd, act, tau);
}

extern "C" int policy_pd_bf16_launch(const float* x, const float* qj, const float* vj,
                                     const float* W1, const float* b1, const void* W2,
                                     const float* b2, const void* W3, const float* b3,
                                     const void* W4, const float* b4, float* act, float* tau,
                                     int B, int n_in, int h1, int h2, int h3, int n4,
                                     int n_out, float kp, float kd, void* stream) {
  int dmax = h1;
  if (h2 > dmax) dmax = h2;
  if (h3 > dmax) dmax = h3;
  const int smem = (PB_STAGES * PB_KT * PB_LDW + 2 * PB_TM * (dmax + PB_PAD)) *
                       (int)sizeof(__nv_bfloat16) +
                   PB_TM * n_in * (int)sizeof(float);
  // the largest dynamic shared memory allowed so far, per device
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(policy_pd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  const int grid = (B + PB_TM - 1) / PB_TM;
  policy_pd_bf16_kernel<<<grid, PB_THREADS, smem, (cudaStream_t)stream>>>(
      x, qj, vj, W1, b1, (const __nv_bfloat16*)W2, b2, (const __nv_bfloat16*)W3, b3,
      (const __nv_bfloat16*)W4, b4, act, tau, B, n_in, h1, h2, h3, n4, n_out, dmax, kp, kd);
  return (int)cudaGetLastError();
}
