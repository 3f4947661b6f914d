// policy_pd_bf16: the learned policy's batched serving step with bf16
// products on the tensor cores. For B environments, the BatchNorm-folded
// MLP n_in -> h1 -> h2 -> h3 -> n_out (ReLU after the hidden layers) and
// the joint PD torque:
//   h1  = relu(x W1 + b1)                          fp32 (K = n_in = 47)
//   h2  = relu(bf16(h1) W2 + b2), h3 likewise      bf16 x bf16 -> fp32 sums
//   act = bf16(h3) W4 + b4,  tau = kp (act - qj) - kd vj          fp32
// x (B, n_in), qj, vj (B, n_out) fp32; W1 (n_in, h1) fp32 row-major; W2
// (h1, h2), W3 (h2, h3), W4 (h3, 16) bf16 row-major (W4 padded with zero
// columns past n_out <= 16); biases fp32 (b4 has n_out entries). h1-h3 are
// multiples of 16 and at most PB_HMAX = 1024 (the factory pads any width
// with zeros, ops/policy_pd.py).
//
// Replaces iterative_learning_nmpc_tpu/ops/policy_kernel.py
// make_fused_policy_pd (_policy_pd_kernel) with compute_dtype=bfloat16:
// activations are rounded to bf16 (round to nearest even) where the TPU
// kernel casts them, at the inputs of layers 2-4 after the fp32 bias and
// ReLU; the weights were rounded once by the factory.
//
// Bound on this card: layers 2-4 are 2 B (h1 h2 + h2 h3 + h3 n_out) flops on
// the bf16 tensor cores (989 TFLOP/s dense), layer 1 2 B n_in h1 on the fp32
// cores (67 TFLOP/s), against 1.2 MB of weights for the 47 -> 512x3 -> 12
// net (3.35 TB/s; they stay in the 50 MB L2): 0.46 us at B = 256, 7.3 us at
// 4096. What held the first design back (one block of 16 rows streaming
// every weight, B = 256 on 16 SMs, W1 read by one global load per k) and
// what this one does about it:
// - Columns over a cluster. A cluster of PB_CLUSTER = 8 blocks shares a
//   tile of R rows; block (rank) c owns column slice c of every hidden
//   layer, cw = 64 columns (128 when the layer is wider than 512; ragged or
//   empty at the end), and only ever loads that slice of W1-W3 and the
//   matching cw rows of W4: 145 KB a block for the shipped net, not 1.2 MB.
// - Weights by TMA into a ring. A producer warp's lane 0 streams the
//   block's chunks, each 16 KB: one or two boxes of a 2-D tensor map (64
//   columns x 64-128 rows; W1 in fp32, W2 and W3 in bf16 with the 128-byte
//   swizzle, so the ldmatrix reads of 8 rows hit 8 different bank groups),
//   W4's rows by one 1-D bulk copy. The ring streams them again for each
//   row tile (slots freed by one arrival per consumer warp), the copies
//   running across layer and tile boundaries. (Keeping them resident where
//   they all fit gained nothing on the card: no launch that walks more
//   than one tile a cluster has room for them.)
// - Persistent clusters over row tiles. The grid is min(tiles, the clusters
//   the card holds at once) clusters (15 on an H100 SXM), each walking
//   tiles c, c + grid, ...
// - Layer 1 from shared memory: a thread owns 4 rows x 4 columns of the
//   block's slice, one float4 of x (k-major) and one of W1 a k. The next
//   tile's x is loaded into registers a tile ahead.
// - Layers 2-4 on mma.sync m16n8k16 (bf16 in, fp32 sums). Measured on the
//   card: 31 cycles from one mma to the next on its accumulator, 58 from
//   an ldmatrix to its use, 607 TFLOP/s with 8 warps of 8 independent
//   chains. A warp owns a 16 x 32 tile (four chains, one A and two B
//   ldmatrix a k step); when the slice has fewer than 8 such tiles the k
//   steps are split over 8 / tiles warps, their partial tiles summed
//   through shared memory. A fragments by ldmatrix from the activations, B
//   by ldmatrix.trans from the ring, every address fixed but for the span.
// - Activations stay on chip. A block writes its slice of a hidden layer's
//   output (bf16, each row's 16-byte pieces swizzled by row % 8 so that
//   ldmatrix is conflict-free without padding) to a staging buffer, and
//   threads 0-7 copy it, one bulk copy each (shared -> shared::cluster),
//   into slot c of every block's input buffer, each copy counted in bytes
//   on the receiver's mbarrier. The layer-3 slice stays in the block:
//   layer 4 is split over K, each block multiplies its slice by its rows of
//   W4 and copies its R x 16 partial sums, R / 8 rows to each block, which
//   sums the 8 partials in rank order, adds b4 and applies the PD step.
// Buffer reuse needs no extra barrier: a block sends tile t + 1's layer-1
// and layer-2 slices only after it has every peer's partial sums of tile t,
// which each peer sends after its layer-2 and layer-3 reads of tile t and
// after every copy into it of tile t has landed. A block whose slices of
// layers 1-2 are empty takes no part in those exchanges, so nothing orders
// its reads of tile t's partial sums before the peers' sums of tile t + 1:
// the partial sums (sent and received) and their barrier alternate
// between two buffers by tile parity, and tile t + 2's sums need this
// block's own sums of tile t + 1. The input barriers complete once a tile,
// the partial-sum barriers every other tile; thread 0 re-arms each right
// after its wait (bytes that arrive before the arming count down from 0).
// One cluster barrier after the mbarriers' initialization, one at the end
// (no block leaves while a peer's copies may still read its memory).
// ROWS RULE, from the card (R = 16, 32 and 64 each timed there; PERF.md
// keeps the readings): a tile costs mostly fixed latency (three cluster
// exchanges and the block barriers, ~11 us at R = 16 and ~14 at R = 32 for
// the shipped net), so R = 32 while its tiles take one pass of the grid (B
// <= 480), else R = 64 where it fits (the 47 -> 512x3 -> 12 net; its ring
// holds 2 of the 10 chunks, so its weights stream every tile), else 32. The
// shipped net: B = 256 -> 8 clusters of one 32-row tile (64 SMs; 16-row
// tiles on all 15 clusters, two passes, measured 39 % slower); B = 1000 ->
// 15 clusters, 16 tiles of 64; B = 4096 -> 15 clusters, 64 tiles of 64.
// With -DPB_TRACE, thread 0 of each block writes %globaltimer at the ends
// of each row tile's phases into pb_stamps
// (scripts/trace_policy_kernel_torch.py --bf16); the shipped build has
// none. Rows past B read zeros and write nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PB_CLUSTER 8                     // blocks of a cluster: the column slices
#define PB_CONSUMERS 256                 // 8 consumer warps
#define PB_THREADS (PB_CONSUMERS + 32)   // and a producer warp
#define PB_BOX 64                        // columns of a weight box
#define PB_SLOT 16384                    // bytes of a ring slot
#define PB_NOUT 16                       // W4's columns
#define PB_HMAX 1024                     // widest hidden layer
#define PB_ERR_SMEM (-1)                 // no row tile fits the card's shared memory

typedef __nv_bfloat16 bf16;

#ifdef PB_TRACE
#define PB_TMAX 32   // row tiles traced a block
#define PB_NST 10    // stamps a tile
__device__ unsigned long long pb_stamps[128 * PB_TMAX * PB_NST];
#define PB_STAMP(it, i)                                                              \
  do {                                                                               \
    if (threadIdx.x == 0 && (it) < PB_TMAX) {                                        \
      unsigned long long t_;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                        \
      pb_stamps[(blockIdx.x * PB_TMAX + (it)) * PB_NST + (i)] = t_;                  \
    }                                                                                \
  } while (0)
extern "C" int pb_trace_shape(int* out) {
  out[0] = PB_TMAX;
  out[1] = PB_NST;
  return 0;
}
extern "C" int pb_read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, pb_stamps, (size_t)n * 8);
}
#else
#define PB_STAMP(it, i) \
  do {                  \
  } while (0)
#endif

// ---- Hopper primitives ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival, and `bytes` more to come by copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// wait for a phase completed by other blocks' copies, acquiring their data
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// a box of a 2-D tensor map (origin: column c, row k; out-of-range elements
// read as zeros) -> this block's shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c, int k,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(k), "r"(smem_u32(bar))
      : "memory");
}
// contiguous global -> this block's shared memory, completing on bar
// (16-byte aligned addresses, bytes a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// this block's shared memory -> cluster address dst (another block's, or
// this one's), counted in bytes on the mbarrier at cluster address bar
__device__ __forceinline__ void bulk_send(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// this block's generic-proxy shared-memory writes, before copies read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}
// the 8 consumer warps only (the producer warp runs its own loop)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PB_CONSUMERS) : "memory");
}
// the address of the same shared-memory variable in block `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// four 8x8 bf16 matrices; lane l gives the shared address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// the same, transposed (B fragments of a row-major [k][n] tile)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// two transposed matrices; lanes 0-15 give the addresses
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// d += a (16x16, row) b (16x8, col): bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ---- end of primitives ----

// W1-W3 as 2-D tensor maps with PB_BOX-column boxes; the rest plain.
struct PBArgs {
  CUtensorMap map[3];
  const float *x, *qj, *vj;
  const bf16* W4;
  const float* b[4];
  float *act, *tau;
  int B, dims[5];   // n_in, h1, h2, h3, n_out
  int slots;        // ring slots
  int tiles;        // row tiles of the batch
  float kp, kd;
};

// columns of a slice of a hidden layer of width h: 64, or 128 past 512
__host__ __device__ __forceinline__ int pb_cw(int h) {
  return PB_BOX * ((h + PB_CLUSTER * PB_BOX - 1) / (PB_CLUSTER * PB_BOX));
}
// the columns of that slice block r holds (a multiple of 16, maybe 0)
__host__ __device__ __forceinline__ int pb_width(int h, int r) {
  const int cw = pb_cw(h), w = h - r * cw;
  return w < 0 ? 0 : (w > cw ? cw : w);
}
// weight rows of a chunk of layer l (0: W1 in fp32; 1, 2: W2, W3 in bf16)
__host__ __device__ __forceinline__ int pb_kc(int l, int h) {
  return PB_SLOT / (pb_cw(h) * (l == 0 ? 4 : 2));
}

// The chunk stream of block r for one row tile: n[l] chunks of layer l
// (W1-W3 in chunks of pb_kc rows at the block's slice, W4's rows in one),
// none for a layer whose slice is empty.
struct PBStream {
  int n[4], total;
  __host__ __device__ PBStream(const int* d, int r) {
    total = 0;
    for (int l = 0; l < 3; ++l) {
      const int kc = pb_kc(l, d[l + 1]);
      n[l] = pb_width(d[l + 1], r) > 0 ? (d[l] + kc - 1) / kc : 0;
      total += n[l];
    }
    n[3] = pb_width(d[3], r) > 0 ? 1 : 0;
    total += n[3];
  }
};

// Byte offsets of the dynamic shared memory (after alignment to 1024 B):
// the ring, the layer-2 and layer-3 inputs (8 slices of R rows each), the
// staging of the block's layer-1 and layer-2 slices, its layer-3 slice, the
// x tile (k-major), its partial sums of layer 4 and the partial sums it
// receives (8 sources x R / 8 rows), each twice (by tile parity), and the
// mbarriers.
struct PBLayout {
  int hA, hB, s1, s2, h3, xs, sp, part, bars, bytes;
  __host__ __device__ PBLayout(int R, const int* d, int slots) {
    const int l1 = pb_cw(d[1]), l2 = pb_cw(d[2]), l3 = pb_cw(d[3]);
    hA = slots * PB_SLOT;
    hB = hA + PB_CLUSTER * R * l1 * 2;
    s1 = hB + PB_CLUSTER * R * l2 * 2;
    s2 = s1 + R * l1 * 2;
    h3 = s2 + R * l2 * 2;
    xs = h3 + R * l3 * 2;
    sp = xs + ((R * d[0] * 4 + 15) & ~15);
    part = sp + 2 * R * PB_NOUT * 4;
    bars = part + 2 * R * PB_NOUT * 4;
    bytes = bars + (2 * slots + 4) * 8;
  }
};

// The ring as the consumers see it: chunk g's slot, waited for, and freed.
struct PBRing {
  unsigned char* base;
  uint64_t *full, *empty;
  int S;
  __device__ const unsigned char* wait(int g) const {
    const int s = g % S;
    mbar_wait(&full[s], (unsigned)((g / S) & 1));
    return base + s * PB_SLOT;
  }
  __device__ void done(int g, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[g % S]);
  }
};

// element offset of (row r, column c) of an activation tile ld columns
// wide: the 16-byte pieces of row r swizzled by r % 8 (for a bf16 chunk of
// weights, TMA's 128-byte swizzle does the same to each 64-column box)
__device__ __forceinline__ int pb_act(int r, int c, int ld) {
  const int j = c >> 3;
  return r * ld + (((j ^ r) & 7) | (j & ~7)) * 8 + (c & 7);
}

// Layer 1 in fp32: out (R x cw, bf16, the block's slice of w columns) =
// bf16(relu(x W1 + b1)), x k-major in xs. A thread owns rows 4 rq .. + 3
// and slice columns 4 cq .. + 3 (bb: b1 there, read once by bias_l1).
// Consumes chunks g ... ; returns the next.
template <int RT>
__device__ __forceinline__ void bias_l1(const float* __restrict__ b, int c0, int w,
                                        float (&bb)[4]) {
  const int col = 4 * ((int)threadIdx.x / (4 * RT));
#pragma unroll
  for (int k = 0; k < 4; ++k) bb[k] = col + k < w ? __ldg(b + c0 + col + k) : 0.f;
}
template <int RT>
__device__ __forceinline__ int layer1(const float* xs, int n_in, const PBRing& ring, int g,
                                      int nch, int kc, int cw, const float (&bb)[4], int w,
                                      bf16* out) {
  constexpr int R = 16 * RT, RQ = R / 4;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rq = tid % RQ, cq = tid / RQ;
  const bool on = cq * 4 < w;
  const int nb = cw / PB_BOX;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int j = 0; j < nch; ++j, ++g) {
    const float* sw = reinterpret_cast<const float*>(ring.wait(g));
    if (on) {
      const float* wb = sw + (cq / 16) * (PB_SLOT / 4 / nb) + (cq % 16) * 4;
      const int k0 = j * kc, rows = min(kc, n_in - k0);
#pragma unroll 4
      for (int kr = 0; kr < rows; ++kr) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (k0 + kr) * R + 4 * rq);
        const float4 wv = *reinterpret_cast<const float4*>(wb + kr * PB_BOX);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xa[i], wa[k], acc[i][k]);
      }
    }
    ring.done(g, lane);
  }
  if (on) {
    const int col = 4 * cq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + pb_act(4 * rq + i, col, cw));
      o[0] = __floats2bfloat162_rn(fmaxf(acc[i][0] + bb[0], 0.f), fmaxf(acc[i][1] + bb[1], 0.f));
      o[1] = __floats2bfloat162_rn(fmaxf(acc[i][2] + bb[2], 0.f), fmaxf(acc[i][3] + bb[3], 0.f));
    }
  }
  return g;
}

// A hidden layer on the tensor cores: out (R x cw, bf16, the block's slice
// of w <= cw columns) = bf16(relu(in W + b)), with in (R x K) held as 8
// slices of R x cwi (pb_act; cwi = 64 << wide) and W's slice streamed as
// chunks of kc rows (64-column boxes of kc x 128 bytes, TMA's 128-byte
// swizzle). The R x cw output is U = R cw / 512 tiles of 16 x 32 (pb_tiles);
// warp w owns tile w % U (four 8-column accumulators) over the k steps s
// with s % ks = w / U, ks = 8 / U, and the ks partial tiles meet in red
// (the input buffer, which no warp reads after the k loop) before warps
// w < U add the bias (bz, read once by bias_mma), apply ReLU and write. A
// lane's ldmatrix addresses are fixed but for the span: row b_k of a
// 16-row step of B, whose swizzle key is lane % 8 at every step, and row
// a_row of A, whose pieces for the warp's steps of a span are offa. (A
// runtime modulo and per-step index arithmetic in this loop cost more than
// its ldmatrix and mma together, measured on the card.) Returns the next
// chunk.
template <int RT>
__device__ __forceinline__ void pb_tiles(int cw, int& ks, int& kh, int& mt, int& n0) {
  const int nq = cw / 32, units = RT * nq, warp = (int)threadIdx.x >> 5, u = warp % units;
  ks = 8 / units;
  kh = warp / units;
  mt = u / nq;
  n0 = (u - mt * nq) * 32;
}
template <int RT>
__device__ __forceinline__ void bias_mma(const float* __restrict__ b, int c0, int w, int cw,
                                         float (&bz)[4][2]) {
  int ks, kh, mt, n0;
  pb_tiles<RT>(cw, ks, kh, mt, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * i + 2 * ((int)threadIdx.x & 3) + e;
      bz[i][e] = col < w ? __ldg(b + c0 + col) : 0.f;
    }
}
template <int RT>
__device__ __forceinline__ int mma_layer(const bf16* in, int K, bool wide, const PBRing& ring,
                                         int g, int nch, int kc, int cw,
                                         const float (&bz)[4][2], int w, bf16* out) {
  constexpr int R = 16 * RT;
  const int lane = threadIdx.x & 31, cwi = 64 << wide;
  int ks, kh, mt, n0;
  pb_tiles<RT>(cw, ks, kh, mt, n0);
  const bool on = n0 < w;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // the warp's k steps within each 64-column span of the input: u_i = kh +
  // i ks for i < ns = 4 / ks; for each, A's swizzled piece at row a_row and
  // B's row offset (16 rows of 128 bytes a step)
  const int ns = 4 / ks, a_row = mt * 16 + (lane & 15);
  const unsigned a_base = smem_u32(in) + (unsigned)(a_row * cwi * 2);
  int us[4];
  unsigned offa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    us[i] = kh + i * ks;
    offa[i] = (unsigned)((((2 * us[i] + (lane >> 4)) ^ a_row) & 7) << 4);
  }
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  unsigned offb[4][2];   // step i, the 8-column tile pairs (0, 1) and (2, 3)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 16 * h + (lane >> 4) * 8;
    const unsigned o =
        (unsigned)((n >> 6) * kc * 128 + b_k * 128 + ((((n >> 3) & 7) ^ (lane & 7)) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) offb[i][h] = o + (unsigned)(us[i] * 2048);
  }
  for (int j = 0; j < nch; ++j, ++g) {
    const unsigned sw = smem_u32(ring.wait(g));
    if (on) {
      const int k0 = j * kc, steps = min(kc, K - k0) >> 4;
      for (int s0 = 0; s0 < steps; s0 += 4) {   // a 64-column span of the input
        const int k = k0 + 16 * s0, src = k >> (6 + wide);
        const unsigned ab = a_base + (unsigned)((src * R * cwi + (k & (cwi - 1) & 64)) * 2);
        const unsigned bb = sw + (unsigned)(s0 * 2048);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < ns && s0 + us[i] < steps) {
            uint32_t a[4], b0[4], b1[4];
            ldsm_x4(a, ab + offa[i]);
            ldsm_x4_t(b0, bb + offb[i][0]);
            ldsm_x4_t(b1, bb + offb[i][1]);
            mma_bf16(acc[0], a, b0[0], b0[1]);
            mma_bf16(acc[1], a, b0[2], b0[3]);
            mma_bf16(acc[2], a, b1[0], b1[1]);
            mma_bf16(acc[3], a, b1[2], b1[3]);
          }
        }
      }
    }
    ring.done(g, lane);
  }
  if (ks > 1) {   // the partial tiles of warps kh > 0 to warp kh = 0 of each tile
    float* red = reinterpret_cast<float*>(const_cast<bf16*>(in));
    const int units = 8 / ks, slot = ((kh - 1) * units + (int)(threadIdx.x >> 5) % units) * 32;
    consumers_sync();
    if (kh > 0 && on)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(red + ((slot + lane) * 4 + i) * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    consumers_sync();
    if (kh == 0 && on)
      for (int q = 1; q < ks; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              red + ((((q - 1) * units + (int)(threadIdx.x >> 5)) * 32 + lane) * 4 + i) * 4);
          acc[i][0] += v.x;
          acc[i][1] += v.y;
          acc[i][2] += v.z;
          acc[i][3] += v.w;
        }
  }
  if (on && kh == 0) {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(out + pb_act(mt * 16 + gr + 8 * h, col, cw)) =
            __floats2bfloat162_rn(fmaxf(acc[i][2 * h] + bz[i][0], 0.f),
                                  fmaxf(acc[i][2 * h + 1] + bz[i][1], 0.f));
    }
  }
  return g;
}

// The producer: lane 0 of the last warp streams the block's chunks for each
// row tile, each into its slot once the consumer warps have freed the
// slot's previous chunk.
__device__ __forceinline__ void produce(const PBArgs& a, const PBStream& st, unsigned rank,
                                        const PBRing& ring, int passes) {
  const int* d = a.dims;
  int g = 0;
  for (int it = 0; it < passes; ++it)
    for (int l = 0; l < 4; ++l)
      for (int j = 0; j < st.n[l]; ++j, ++g) {
        const int s = g % ring.S;
        if (g >= ring.S) mbar_wait(&ring.empty[s], (unsigned)((g / ring.S - 1) & 1));
        unsigned char* slot = ring.base + s * PB_SLOT;
        if (l < 3) {
          const int cw = pb_cw(d[l + 1]), nb = cw / PB_BOX;
          mbar_expect_tx(&ring.full[s], PB_SLOT);   // the whole boxes, zeros included
          for (int bx = 0; bx < nb; ++bx)
            tma_load_2d(slot + bx * (PB_SLOT / nb), &a.map[l], (int)rank * cw + bx * PB_BOX,
                        j * pb_kc(l, d[l + 1]), &ring.full[s]);
        } else {
          const unsigned bytes = (unsigned)(pb_width(d[3], rank) * PB_NOUT * 2);
          mbar_expect_tx(&ring.full[s], bytes);
          bulk_load(slot, a.W4 + (size_t)rank * pb_cw(d[3]) * PB_NOUT, bytes, &ring.full[s]);
        }
      }
}

template <int RT>
__global__ void __launch_bounds__(PB_THREADS, 1)
    policy_pd_bf16_kernel(const __grid_constant__ PBArgs a) {
  constexpr int R = 16 * RT, RO = R / PB_CLUSTER;   // rows whose epilogue a block owns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int* d = a.dims;
  const PBLayout L(R, d, a.slots);
  bf16* hA = reinterpret_cast<bf16*>(sm + L.hA);
  bf16* hB = reinterpret_cast<bf16*>(sm + L.hB);
  bf16* s1 = reinterpret_cast<bf16*>(sm + L.s1);
  bf16* s2 = reinterpret_cast<bf16*>(sm + L.s2);
  bf16* h3 = reinterpret_cast<bf16*>(sm + L.h3);
  float* xs = reinterpret_cast<float*>(sm + L.xs);
  float* sp = reinterpret_cast<float*>(sm + L.sp);
  float* part = reinterpret_cast<float*>(sm + L.part);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + a.slots;
  uint64_t* xbar = empty + a.slots;   // [layer 2 input, layer 3 input] arrived
  uint64_t* pbar = xbar + 2;          // the layer-4 partial sums arrived, by tile parity

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned rank = cluster_rank();
  const int cid = blockIdx.x / PB_CLUSTER, ncl = gridDim.x / PB_CLUSTER;
  const int ntile = (a.tiles - cid + ncl - 1) / ncl;   // this cluster's row tiles
  const PBStream st(d, (int)rank);
  PBRing ring;
  ring.base = sm;
  ring.full = full;
  ring.empty = empty;
  ring.S = min(st.total, a.slots);
  int cw[3], w[3], expect[2] = {0, 0};
  for (int l = 0; l < 3; ++l) {
    cw[l] = pb_cw(d[l + 1]);
    w[l] = pb_width(d[l + 1], (int)rank);
  }
  for (int l = 0; l < 2; ++l)
    for (int p = 0; p < PB_CLUSTER; ++p)
      if (pb_width(d[l + 1], p) > 0) expect[l] += R * cw[l] * 2;
  const unsigned expect_part = R * PB_NOUT * 4;

  if (tid == 0) {
    for (int s = 0; s < ring.S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PB_CONSUMERS / 32);
    }
    for (int l = 0; l < 2; ++l) {
      mbar_init(&xbar[l], 1);
      mbar_expect_tx(&xbar[l], (unsigned)expect[l]);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&pbar[q], 1);
      mbar_expect_tx(&pbar[q], expect_part);
    }
    mbar_init_fence();
  }
  cluster_sync();   // every block's mbarriers exist before any remote access

  if (warp == PB_CONSUMERS / 32) {
    if (lane == 0 && st.total > 0) produce(a, st, rank, ring, ntile);
    __syncwarp();
  } else {
    // read once: the biases at this thread's columns, b4 at its output
    float bb1[4], bz2[4][2], bz3[4][2];
    bias_l1<RT>(a.b[0], (int)rank * cw[0], w[0], bb1);
    bias_mma<RT>(a.b[1], (int)rank * cw[1], w[1], cw[1], bz2);
    bias_mma<RT>(a.b[2], (int)rank * cw[2], w[2], cw[2], bz3);
    const int n_out = d[4], eo = tid / n_out, en = tid - eo * n_out;   // the output it sums
    const bool e_on = tid < RO * n_out;
    const float b4 = e_on ? __ldg(a.b[3] + en) : 0.f;
    // the next tile's x, XP values a thread (n_in <= 64; the rest read in
    // place), value q at xs[xo[q]] = xs[k R + m] for x[row0 + m][k]
    constexpr int XP = R / 4;
    const int nx = R * d[0];
    int xo[XP];
    float xn[XP];
#pragma unroll
    for (int q = 0; q < XP; ++q) {
      const int i = tid + PB_CONSUMERS * q, m = i / d[0];
      xo[q] = i < nx ? (i - m * d[0]) * R + m : -1;
      xn[q] = xo[q] >= 0 && cid * R + m < a.B ? __ldg(a.x + (size_t)cid * R * d[0] + i) : 0.f;
    }
    for (int it = 0; it < ntile; ++it) {
      const int row0 = (cid + it * ncl) * R, next0 = row0 + ncl * R;
      const int q = it & 1;
      const unsigned par = (unsigned)q;
      const bool more = it + 1 < ntile;
      float* spq = sp + q * R * PB_NOUT;
      float* partq = part + q * R * PB_NOUT;
      int g = it * st.total;
      PB_STAMP(it, 0);
      // this tile's x into xs (k-major), then the next tile's loads issued
#pragma unroll
      for (int j = 0; j < XP; ++j)
        if (xo[j] >= 0) xs[xo[j]] = xn[j];
      for (int i = tid + PB_CONSUMERS * XP; i < nx; i += PB_CONSUMERS) {
        const int m = i / d[0];
        xs[(i - m * d[0]) * R + m] = row0 + m < a.B ? __ldg(a.x + (size_t)row0 * d[0] + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < XP; ++j)
        xn[j] = more && xo[j] >= 0 && next0 + (xo[j] & (R - 1)) < a.B
                    ? __ldg(a.x + (size_t)next0 * d[0] + tid + PB_CONSUMERS * j)
                    : 0.f;
      // the PD inputs of the output this thread sums
      const int erow = row0 + (int)rank * RO + eo;
      const bool e_in = e_on && erow < a.B;
      const size_t eidx = (size_t)erow * n_out + en;
      const float pq = e_in ? __ldg(a.qj + eidx) : 0.f, pv = e_in ? __ldg(a.vj + eidx) : 0.f;
      consumers_sync();
      PB_STAMP(it, 1);
      if (w[0] > 0) {   // layer 1, then the slice to every block's layer-2 input
        g = layer1<RT>(xs, d[0], ring, g, st.n[0], pb_kc(0, d[1]), cw[0], bb1, w[0], s1);
        consumers_sync();
        if (tid < PB_CLUSTER) {   // thread p copies to block p
          fence_proxy_async();
          bulk_send(map_rank(hA + rank * R * cw[0], tid), s1, (unsigned)(R * cw[0] * 2),
                    map_rank(&xbar[0], tid));
        }
      }
      PB_STAMP(it, 2);
      mbar_wait_cluster(&xbar[0], par);
      if (tid == 0 && more) mbar_expect_tx(&xbar[0], (unsigned)expect[0]);
      PB_STAMP(it, 3);
      if (w[1] > 0) {   // layer 2, then the slice to every block's layer-3 input
        g = mma_layer<RT>(hA, d[1], cw[0] > 64, ring, g, st.n[1], pb_kc(1, d[2]), cw[1], bz2,
                          w[1], s2);
        consumers_sync();
        if (tid < PB_CLUSTER) {
          fence_proxy_async();
          bulk_send(map_rank(hB + rank * R * cw[1], tid), s2, (unsigned)(R * cw[1] * 2),
                    map_rank(&xbar[1], tid));
        }
      }
      PB_STAMP(it, 4);
      mbar_wait_cluster(&xbar[1], par);
      if (tid == 0 && more) mbar_expect_tx(&xbar[1], (unsigned)expect[1]);
      PB_STAMP(it, 5);
      if (w[2] > 0)     // layer 3: the slice stays here
        g = mma_layer<RT>(hB, d[2], cw[1] > 64, ring, g, st.n[2], pb_kc(2, d[3]), cw[2], bz3,
                          w[2], h3);
      consumers_sync();
      PB_STAMP(it, 6);
      // layer 4 over K: the slice times its w rows of W4 (16 x 16 tiles of
      // the R x 16 partial sums, warp mt for rows mt 16 ..), zeros for an
      // empty slice
      float acc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      if (st.n[3]) {
        const unsigned char* sw = ring.wait(g);
        if (warp < RT) {
          const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
          for (int kk = 0; kk < w[2]; kk += 16) {
            uint32_t af[4], bf[4];
            ldsm_x4(af, smem_u32(h3 + pb_act(warp * 16 + (lane & 15), kk + (lane >> 4) * 8,
                                             cw[2])));
            ldsm_x4_t(bf, smem_u32(sw + ((kk + b_k) * PB_NOUT + b_n) * 2));
            mma_bf16(acc[0], af, bf[0], bf[1]);
            mma_bf16(acc[1], af, bf[2], bf[3]);
          }
        }
        ring.done(g, lane);
        ++g;
      }
      if (warp < RT) {
        const int gr = lane >> 2, t = lane & 3;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(spq + (warp * 16 + gr + 8 * h) * PB_NOUT + n * 8 + 2 * t) =
                make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
      consumers_sync();
      PB_STAMP(it, 7);
      if (tid < PB_CLUSTER) {   // rows p RO .. + RO - 1 to block p = tid
        fence_proxy_async();
        bulk_send(map_rank(partq + rank * RO * PB_NOUT, tid), spq + tid * RO * PB_NOUT,
                  (unsigned)(RO * PB_NOUT * 4), map_rank(&pbar[q], tid));
      }
      mbar_wait_cluster(&pbar[q], (unsigned)((it >> 1) & 1));
      if (tid == 0 && it + 2 < ntile) mbar_expect_tx(&pbar[q], expect_part);
      PB_STAMP(it, 8);
      if (e_in) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < PB_CLUSTER; ++p) s += partq[(p * RO + eo) * PB_NOUT + en];
        const float v = s + b4;
        a.act[eidx] = v;
        a.tau[eidx] = a.kp * (v - pq) - a.kd * pv;
      }
      PB_STAMP(it, 9);
    }
  }
  cluster_sync();   // no block leaves while a peer's copies may still read its shared memory
}

// ---- the launch ----
typedef void (*PBKernel)(PBArgs);
static PBKernel pb_kernel(int rt) {
  return rt == 2 ? policy_pd_bf16_kernel<2> : policy_pd_bf16_kernel<4>;
}

static void pb_cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                              int smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(PB_THREADS);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = PB_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The device's opt-in shared memory a block, read once per device; each
// instance is then allowed to take all of it.
static cudaError_t pb_smem_optin(int* optin, int* dev_out) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *dev_out = dev;
  if (dev < 64 && known[dev]) {
    *optin = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  for (int rt = 2; rt <= 4; rt *= 2) {
    err = cudaFuncSetAttribute((const void*)pb_kernel(rt),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) known[dev] = *optin;
  return cudaSuccess;
}

// The clusters of one instance and shared-memory size the card holds at
// once (cudaOccupancyMaxActiveClusters), kept per device, instance and size.
static cudaError_t pb_clusters(int dev, int rt, int smem, int* clusters) {
  static int key[32][3], val[32], n = 0;
  for (int i = 0; i < n; ++i)
    if (key[i][0] == dev && key[i][1] == rt && key[i][2] == smem) {
      *clusters = val[i];
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  pb_cluster_config(&cfg, &attr, PB_CLUSTER, smem, nullptr);
  cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, (const void*)pb_kernel(rt), &cfg);
  if (err != cudaSuccess) return err;
  if (*clusters < 1) return cudaErrorInvalidConfiguration;
  const int i = n < 32 ? n++ : 31;
  key[i][0] = dev;
  key[i][1] = rt;
  key[i][2] = smem;
  val[i] = *clusters;
  return cudaSuccess;
}

// A launch's shape: rows a tile, ring slots, dynamic shared memory, row
// tiles, clusters launched and the clusters the card holds at once.
struct PBPlan {
  int rt, slots, smem, tiles, grid, clusters;
};

// The plan for B rows of a net of widths d (ROWS RULE in the note above):
// an instance fits when its ring gets at least two slots (or every chunk)
// and a hidden layer's slice at most eight 16 x 32 tiles (one a warp).
static int pb_plan(int B, const int* d, PBPlan* plan) {
  int optin = 0, dev = 0;
  cudaError_t err = pb_smem_optin(&optin, &dev);
  if (err != cudaSuccess) return (int)err;
  int chunks = 0;
  for (int r = 0; r < PB_CLUSTER; ++r) {
    const int t = PBStream(d, r).total;
    chunks = t > chunks ? t : chunks;
  }
  PBPlan fit[2];
  int nfit = 0;
  for (int rt = 2; rt <= 4; rt *= 2) {
    bool ok = true;
    for (int l = 1; l <= 3; ++l) ok = ok && rt * pb_cw(d[l]) / 32 <= 8;   // pb_tiles
    const int fixed = PBLayout(16 * rt, d, 0).bytes + 1024;
    int slots = (optin - fixed) / (PB_SLOT + 16);
    slots = slots < chunks ? slots : chunks;
    if (!ok || slots < 2) continue;
    PBPlan& p = fit[nfit++];
    p.rt = rt;
    p.slots = slots;
    p.smem = PBLayout(16 * rt, d, slots).bytes + 1024;
    p.tiles = (B + 16 * rt - 1) / (16 * rt);
    err = pb_clusters(dev, rt, p.smem, &p.clusters);
    if (err != cudaSuccess) return (int)err;
    p.grid = p.tiles < p.clusters ? p.tiles : p.clusters;
  }
  if (nfit == 0) return PB_ERR_SMEM;
  *plan = fit[0].rt == 2 && fit[0].tiles <= fit[0].clusters ? fit[0] : fit[nfit - 1];
  return 0;
}

static int pb_check(int B, int n_in, int h1, int h2, int h3, int n4, int n_out) {
  const int h[3] = {h1, h2, h3};
  if (B < 1 || n_in < 1 || n4 != PB_NOUT || n_out < 1 || n_out > PB_NOUT)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < 3; ++l)
    if (h[l] < 16 || h[l] > PB_HMAX || h[l] % 16) return (int)cudaErrorInvalidValue;
  return 0;
}

// The compiled kernel that a launch of B rows at these widths takes: out =
// (registers a thread, local bytes a thread, static shared bytes, dynamic
// shared bytes, clusters the card holds at once, rows a tile, clusters
// launched, ring slots).
extern "C" int policy_pd_bf16_attributes(int B, int n_in, int h1, int h2, int h3, int n_out,
                                         int* out) {
  int err = pb_check(B, n_in, h1, h2, h3, PB_NOUT, n_out);
  if (err) return err;
  const int d[5] = {n_in, h1, h2, h3, n_out};
  PBPlan p;
  err = pb_plan(B, d, &p);
  if (err) return err;
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, (const void*)pb_kernel(p.rt));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = p.smem;
  out[4] = p.clusters;
  out[5] = 16 * p.rt;
  out[6] = p.grid;
  out[7] = p.slots;
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// W (K x N, row-major; fp32, or bf16 with the 128-byte swizzle) as a tensor
// map of PB_BOX-column x kc-row boxes.
static int pb_encode(CUtensorMap* map, const void* W, int K, int N, bool fp32, int kc) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiledFn)fn;
  }
  const int es = fp32 ? 4 : 2;
  const cuuint64_t size[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t stride[1] = {(cuuint64_t)N * es};
  const cuuint32_t box[2] = {PB_BOX, (cuuint32_t)kc};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      (void*)W, size, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      fp32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" int policy_pd_bf16_launch(const float* x, const float* qj, const float* vj,
                                     const float* W1, const float* b1, const void* W2,
                                     const float* b2, const void* W3, const float* b3,
                                     const void* W4, const float* b4, float* act, float* tau,
                                     int B, int n_in, int h1, int h2, int h3, int n4,
                                     int n_out, float kp, float kd, void* stream) {
  int err = pb_check(B, n_in, h1, h2, h3, n4, n_out);
  if (err) return err;
  const int d[5] = {n_in, h1, h2, h3, n_out};
  PBPlan p;
  err = pb_plan(B, d, &p);
  if (err) return err;
  PBArgs a;
  const void* W[3] = {W1, W2, W3};
  for (int l = 0; l < 3; ++l) {
    err = pb_encode(&a.map[l], W[l], d[l], d[l + 1], l == 0, pb_kc(l, d[l + 1]));
    if (err) return err;
  }
  a.x = x;
  a.qj = qj;
  a.vj = vj;
  a.W4 = (const bf16*)W4;
  a.b[0] = b1;
  a.b[1] = b2;
  a.b[2] = b3;
  a.b[3] = b4;
  a.act = act;
  a.tau = tau;
  a.B = B;
  for (int i = 0; i < 5; ++i) a.dims[i] = d[i];
  a.slots = p.slots;
  a.tiles = p.tiles;
  a.kp = kp;
  a.kd = kd;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  pb_cluster_config(&cfg, &attr, p.grid * PB_CLUSTER, p.smem, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, pb_kernel(p.rt), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
