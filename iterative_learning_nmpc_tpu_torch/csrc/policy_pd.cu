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
// Bound on this card: fp32 FMA throughput, 2 B (n_in h1 + h1 h2 + h2 h3 +
// h3 n_out) flops (2.8e8 at B = 256 for the 47 -> 512x3 -> 12 net, ~4.2 us
// on 132 SMs), against 2.2 MB of weights that stay in the 50 MB L2. What
// the card makes hard is filling it: B = 256 is 256 rows, and a design
// that gives each block all columns of a few rows (the first version: 32
// blocks of 8 rows) leaves 100 SMs idle and makes every block stream every
// weight. So the columns are spread over a thread-block cluster.
//
// Design. A cluster of PP_CLUSTER = 8 blocks serves R = PP_ROWS = 32 rows
// (16 past 512 hidden units, below); block (rank) c owns column slice c of
// every hidden layer, cw = 4 ceil(h / 32) <= CW = 64 columns wide (128 past
// 512; ragged or empty at the end when h is not a multiple of 32), and only
// ever loads that slice of W1-W3. A block is 8
// consumer warps and one producer warp.
// - Weights arrive by TMA: the producer warp's lane 0 streams the block's
//   chunks, each one box of a 2-D tensor map (cp.async.bulk.tensor; KC =
//   128 weight rows x CW = 64 columns at the slice, or 64 x 128, zeros past
//   the matrix), into a ring of PP_STAGES = 2 slots of 32 KB that complete on
//   mbarriers; a second mbarrier per slot, one arrival per consumer warp,
//   frees it. The stream runs across layer boundaries, so
//   the next layer's chunks load while the current layer computes. (Tried
//   on the card, each slower: one 1-D bulk copy per 256-byte weight row;
//   32- and 64-row chunks; warp 0 starting the copies between its own
//   FMAs: starting a copy holds its thread, which a dedicated producer
//   hides.)
// - Activations live in shared memory, k-major (h[k R + row]), double
//   buffered (layer l reads buffer l % 2), and never go to global memory:
//   after a hidden layer each block pushes its output slice into the other
//   buffer of all 8 blocks through distributed shared memory with st.async
//   (mapa; each store counts its bytes on a per-source mbarrier in the
//   receiving block, armed at the start with the bytes that source sends).
//   A block starts the next layer once every source's bytes have arrived
//   (waiting per chunk for its sources measured slower: an acquire at
//   cluster scope per chunk). A block overwrites a peer's buffer only after
//   that peer has sent its own slice of the layer before, so it has
//   finished reading it (a block whose slice is empty sends nothing and
//   reads only for columns it discards).
// - A consumer warp owns a 16 x 64 tile (a lane 4 rows x 8 columns: one
//   broadcast float4 of activations and two conflict-free float4 of weights
//   feed 32 FMAs) over 1/KS of each chunk's rows; the KS = 8 / (R / 16 x
//   CW / 64) = 4 partial tiles are summed through shared memory (red) once per layer,
//   then bias and ReLU. The biases and the PD inputs the epilogues need are
//   read into registers at the start.
// - The last layer is split over K, not N: each block multiplies the layer-3
//   slice it holds by the matching cw rows of W4 (contiguous: a 1-D bulk
//   copy), pushes its R x n_out partial sums, row by row, to the block that
//   owns those rows (R / 8 rows each; st.async again), and that block sums
//   the 8 partials, adds b4 and applies the PD step.
// The only cluster barrier is the first (every block's mbarriers exist
// before any remote access); every remote write to a block is counted on a
// barrier that block waits for, so a block may exit after its epilogue.
// Rows per cluster: 32 at every B, so the grid is ceil(B / 32) clusters
// (B = 256: 8 clusters, 64 of 132 SMs; B = 4096: 128 clusters in 9 waves of
// the 15 an H100 SXM holds at once). 16 rows were measured slower at B = 256
// (16 clusters, one more than the card holds, so two waves) and faster only
// at B <= 240, a batch no serving path runs. Rows past B read zeros and
// write nothing.
//
// Two layouts, one kernel (a template on rows R, slice width CW and chunk
// rows KC), chosen by the widest hidden layer:
// - hidden widths <= 512 (the shipped net): R = 32, CW = 64, KC = 128. Its
//   shared memory at the shipped widths: ring 2 x 32 KB + activations 2 x 32
//   x 512 x 4 B + partial tiles 32 KB + last-layer sums 1,536 B + 168 B of
//   mbarriers = 231,080 of the 232,448 B a block may take.
// - hidden widths 513..1024: 16 rows a cluster, 128-column slices (a warp
//   tile covers one 64-column half of them), 64-row chunks. Activations of
//   32 rows would take 2 x 32 x 1024 x 4 B = 256 KB alone; at 16 rows they
//   take 128 KB, and a slot (64 x 128 floats) stays 32 KB. At 47 -> 1024 x3
//   -> 12: 65,536 + 131,072 + 32,768 + 768 + 168 = 230,312 B. (A
//   non-portable cluster of 16 with 64-column slices would keep 32 rows but
//   not the 256 KB of activations.) Each block of a cluster then streams
//   twice the columns of half as many rows, so a weight byte feeds 16 rows
//   instead of 32.
// Every layer width must be a multiple of 4, h1-h3 <= 1024, n_out <= 64,
// and the weights 16-byte aligned (checked by the wrapper); the widest of
// n_in, h1, h2 and n_out must leave the block's shared memory within the
// card's opt-in limit (the launch returns PP_ERR_SMEM if not).
//
// Compiled with -DPP_TRACE (scripts/trace_policy_kernel_torch.py), thread 0
// of each block writes %globaltimer at the ends of its phases into
// pp_stamps; the shipped build has no stamps.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PP_CLUSTER 8                   // blocks of a cluster: the column slices
#define PP_CONSUMERS 256               // 8 consumer warps
#define PP_THREADS (PP_CONSUMERS + 32)  // and a producer warp
#define PP_HALF 64                     // columns of a warp tile
#define PP_SLOT 8192                   // floats of a ring slot (32 KB): KC x CW
#define PP_RED (8 * 16 * PP_HALF)      // floats of the partial tiles
#define PP_ROWS 32                     // rows a cluster serves, hidden widths <= 512
#define PP_NARROW 512                  // the widest hidden layer of that layout
#define PP_HMAX 1024                   // and of the wide one (16 rows, CW = 128)
#define PP_STAGES 2                    // ring slots
#define PP_ERR_SMEM (-1)               // the widths need more shared memory than the card has

#ifdef PP_TRACE
#define PP_STAMPS 11
__device__ unsigned long long pp_stamps[1 << 16];
#define PP_STAMP(i)                                                           \
  do {                                                                        \
    if (threadIdx.x == 0) {                                                   \
      unsigned long long t_;                                                  \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      pp_stamps[blockIdx.x * PP_STAMPS + (i)] = t_;                           \
    }                                                                         \
  } while (0)
extern "C" int pp_trace_rows() { return PP_ROWS; }   // the narrow layout's
extern "C" int pp_read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, pp_stamps, (size_t)n * 8);
}
#else
#define PP_STAMP(i) \
  do {              \
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
// wait for a phase completed by other blocks' arrivals, acquiring their writes
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
// contiguous global -> this block's shared memory, completing on bar
// (16-byte aligned addresses, bytes a multiple of 16)
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// a box of a 2-D tensor map (box origin: column c, row k; out-of-range
// elements read as zeros) -> this block's shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int c, int k,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(k), "r"(smem_u32(bar))
      : "memory");
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
  asm volatile("bar.sync 1, %0;\n" ::"n"(PP_CONSUMERS) : "memory");
}
// the address of the same shared-memory variable in block `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// store v at cluster address addr and count its 16 bytes on the mbarrier at
// cluster address bar (in the same block as addr)
__device__ __forceinline__ void st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// W1-W3 as 2-D tensor maps with KC x CW boxes; W4 and the rest plain.
struct PPArgs {
  CUtensorMap map[3];
  const float *x, *qj, *vj;
  const float* W4;
  const float* b[4];
  float *act, *tau;
  int B, dims[5];
  float kp, kd;
};

__host__ __device__ __forceinline__ int pp_slice(int h) { return 4 * ((h + 31) / 32); }
// whether a net takes the wide layout (16 rows, 128-column slices)
__host__ __device__ __forceinline__ bool pp_wide(const int* dims) {
  return dims[1] > PP_NARROW || dims[2] > PP_NARROW || dims[3] > PP_NARROW;
}
// floats of one activation buffer: R rows of the widest layer input
__host__ __device__ __forceinline__ int pp_act_floats(const int* dims, int R) {
  int d = dims[0];
  if (dims[1] > d) d = dims[1];
  if (dims[2] > d) d = dims[2];
  if (pp_slice(dims[3]) > d) d = pp_slice(dims[3]);
  return R * (4 * ((d + 3) / 4));
}

__device__ __forceinline__ void slice_of(int h, unsigned rank, int& c0, int& w) {
  const int cw = pp_slice(h);
  c0 = (int)rank * cw;
  w = max(0, min(cw, h - c0));
}

// The chunk stream of one block: layers 1-3 in boxes of KC weight rows x
// CW columns at the block's slice, then the block's w3 rows of W4 in
// chunks of PP_SLOT / n_out rows (at least one, empty for an empty slice).
template <int KC>
struct Stream {
  int e1, e2, e3, total;   // first chunk of layers 2, 3, 4; chunks in all
  int step4, w3, c03;
  __device__ Stream(const int* dims, unsigned r) {
    e1 = (dims[0] + KC - 1) / KC;
    e2 = e1 + (dims[1] + KC - 1) / KC;
    e3 = e2 + (dims[2] + KC - 1) / KC;
    slice_of(dims[3], r, c03, w3);
    step4 = PP_SLOT / dims[4];
    total = e3 + max(1, (w3 + step4 - 1) / step4);
  }
  // chunk g: layer l (0-3) and its first weight row k0
  __device__ void chunk(int g, int& l, int& k0) const {
    l = g < e1 ? 0 : g < e2 ? 1 : g < e3 ? 2 : 3;
    k0 = l == 0 ? g * KC : l == 1 ? (g - e1) * KC : l == 2 ? (g - e2) * KC
                                                      : (g - e3) * step4;
  }
};

// The producer: lane 0 of the last warp streams every chunk, each into its
// slot once the consumer warps have freed the slot's previous chunk.
template <int KC>
__device__ __forceinline__ void produce(const Stream<KC>& st, const PPArgs& a, unsigned rank,
                                        float* ring, uint64_t* full, uint64_t* empty) {
  for (int g = 0; g < st.total; ++g) {
    const int s = g % PP_STAGES;
    int l, k0;
    st.chunk(g, l, k0);
    if (g >= PP_STAGES) mbar_wait(&empty[s], (unsigned)((g / PP_STAGES - 1) & 1));
    float* slot = ring + s * PP_SLOT;
    if (l < 3) {
      int c0, w;
      slice_of(a.dims[l + 1], rank, c0, w);
      mbar_expect_tx(&full[s], PP_SLOT * 4);   // the whole box, zeros included
      tma_load_2d(slot, &a.map[l], c0, k0, &full[s]);
    } else {
      const int n_out = a.dims[4];
      const unsigned bytes = (unsigned)(min(st.step4, st.w3 - k0) * n_out * 4);
      mbar_expect_tx(&full[s], bytes);
      if (bytes > 0) bulk_load(slot, a.W4 + (size_t)(st.c03 + k0) * n_out, bytes, &full[s]);
    }
  }
}

// Wait for chunk g; its slot.
__device__ __forceinline__ const float* chunk_wait(int g, float* ring, uint64_t* full) {
  const int s = g % PP_STAGES;
  mbar_wait(&full[s], (unsigned)((g / PP_STAGES) & 1));
  return ring + s * PP_SLOT;
}

// This warp is done with chunk g: free its slot (one arrival per warp).
__device__ __forceinline__ void chunk_done(int g, uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[g % PP_STAGES]);
}

// R rows a cluster, CW columns a slice at most, KC weight rows a chunk
template <int R, int CW, int KC>
__global__ void __launch_bounds__(PP_THREADS, 1)
    policy_pd_kernel(const __grid_constant__ PPArgs a) {
  static_assert(KC * CW == PP_SLOT, "a chunk fills one ring slot");
  constexpr int RT = R / 16;          // row tiles of 16
  constexpr int CH = CW / PP_HALF;    // column halves of 64
  constexpr int TILES = RT * CH;      // warp tiles of 16 x 64
  constexpr int KS = 8 / TILES;       // warps sharing a warp tile over K
  constexpr int RO = R / PP_CLUSTER;  // rows whose epilogue a block owns
  constexpr int R4 = R / 4;           // groups of 4 rows
  constexpr int NQ = CW * R4 / PP_CONSUMERS;   // (column, 4 rows) pairs a thread sums
  constexpr int S = PP_STAGES;
  extern __shared__ __align__(128) float smem[];
  const int* dims = a.dims;
  const int n_out = dims[4];
  float* ring = smem;                                  // S x PP_SLOT
  float* h0 = ring + S * PP_SLOT;                      // k-major layer inputs:
  float* h1 = h0 + pp_act_floats(dims, R);             // layer l reads h0 or h1
  float* red = h1 + pp_act_floats(dims, R);            // PP_RED partial tiles
  float* part = red + PP_RED;                          // 8 x RO x n_out
  uint64_t* full = reinterpret_cast<uint64_t*>(part + R * n_out);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;        // [layer 1, 2][source block]: slices arrived
  uint64_t* pbar = xbar + 2 * PP_CLUSTER;   // the last layer's partial sums arrived

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned rank = cluster_rank();
  const int row0 = (int)(blockIdx.x / PP_CLUSTER) * R;
  const Stream<KC> st(dims, rank);
  PP_STAMP(0);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PP_CONSUMERS / 32);
    }
    // the slices' and the partial sums' barriers complete on the bytes that
    // arrive: source p sends R x (its slice of layer l's output) floats
    for (int l = 0; l < 2; ++l)
      for (int p = 0; p < PP_CLUSTER; ++p) {
        int c0, w;
        slice_of(dims[l + 1], (unsigned)p, c0, w);
        mbar_init(&xbar[l * PP_CLUSTER + p], 1);
        mbar_expect_tx(&xbar[l * PP_CLUSTER + p], (unsigned)(R * w * 4));
      }
    mbar_init(pbar, 1);
    mbar_expect_tx(pbar, (unsigned)(R * n_out * 4));
    mbar_init_fence();
  }
  cluster_sync();   // every block's mbarriers exist before any remote access
  if (warp == PP_CONSUMERS / 32) {
    if (lane == 0) produce(st, a, rank, ring, full, empty);
    return;
  }

  // what the epilogues read from global memory, loaded at the start: each
  // hidden layer's bias at the columns this thread sums, and the PD inputs
  float bias[3][NQ];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    int c0, w;
    slice_of(dims[l + 1], rank, c0, w);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = (tid + PP_CONSUMERS * q) / R4;
      bias[l][q] = col < w ? a.b[l][c0 + col] : 0.f;
    }
  }
  float pq[2], pv[2], pb[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + PP_CONSUMERS * e, rl = i / n_out, n = i - rl * n_out;
    const int row = row0 + (int)rank * RO + rl;
    const bool in = i < RO * n_out && row < a.B;
    const size_t o = (size_t)row * n_out + n;
    pq[e] = in ? a.qj[o] : 0.f;
    pv[e] = in ? a.vj[o] : 0.f;
    pb[e] = i < RO * n_out ? a.b[3][n] : 0.f;
  }
  for (int i = tid; i < R * dims[0]; i += PP_CONSUMERS) {
    const int m = i / dims[0], k = i - m * dims[0];
    const int row = row0 + m;
    h0[k * R + m] = row < a.B ? a.x[(size_t)row * dims[0] + k] : 0.f;
  }
  consumers_sync();
  PP_STAMP(1);

  int g = 0;   // the next chunk to consume
  const int tile = warp % TILES, kg = warp / TILES;
  const int rt = tile % RT, ch = tile / RT;
  const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const float* hrow = (l & 1 ? h1 : h0) + rt * 16 + rg * 4;
    if (l > 0)   // every block has sent its slice of this layer's input
      for (int p = 0; p < PP_CLUSTER; ++p) mbar_wait_cluster(&xbar[(l - 1) * PP_CLUSTER + p], 0);
    const int K = dims[l];
    for (int k0 = 0; k0 < K; k0 += KC, ++g) {
      const int rows = min(KC, K - k0);
      const float* sw = chunk_wait(g, ring, full) + ch * PP_HALF;
#pragma unroll 4
      for (int kk = kg; kk < rows; kk += KS) {
        const float4 hv4 = *reinterpret_cast<const float4*>(hrow + (k0 + kk) * R);
        const float4 wa = *reinterpret_cast<const float4*>(sw + kk * CW + 4 * cg);
        const float4 wb = *reinterpret_cast<const float4*>(sw + kk * CW + 32 + 4 * cg);
        const float hv[4] = {hv4.x, hv4.y, hv4.z, hv4.w};
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
      chunk_done(g, empty, lane);
    }
    PP_STAMP(2 + 2 * l);
    if (l > 0) consumers_sync();   // the previous layer's partial tiles are read
    // the warp's tile, column-major (red[(warp 64 + col) 16 + row], col
    // within its half)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * cg : 32 + 4 * cg) + (j & 3);
      *reinterpret_cast<float4*>(red + (warp * PP_HALF + col) * 16 + rg * 4) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
    consumers_sync();
    // sum the KS partial tiles: thread -> 4 rows of one column per pass,
    // consecutive threads on consecutive rows; bias, ReLU, then out
    int c0, w;
    slice_of(dims[l + 1], rank, c0, w);
    float* hout = l & 1 ? h0 : h1;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int idx = tid + PP_CONSUMERS * q;
      const int col = idx / R4, row = (idx % R4) * 4;
      const int wt = (col / PP_HALF) * RT + (row >> 4);   // the warp tile holding it
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(
            red + ((k * TILES + wt) * PP_HALF + col % PP_HALF) * 16 + (row & 15));
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      const float bn = bias[l][q];
      const float4 v = make_float4(fmaxf(s.x + bn, 0.f), fmaxf(s.y + bn, 0.f),
                                   fmaxf(s.z + bn, 0.f), fmaxf(s.w + bn, 0.f));
      if (col >= w) continue;
      if (l < 2) {   // into the next input of every block of the cluster
        const float* dst = hout + (c0 + col) * R + row;
        uint64_t* bar = &xbar[l * PP_CLUSTER + rank];
#pragma unroll
        for (unsigned p = 0; p < PP_CLUSTER; ++p) st_async(map_rank(dst, p), v, map_rank(bar, p));
      } else {       // the layer-3 slice stays here, k-major over its columns
        *reinterpret_cast<float4*>(hout + col * R + row) = v;
      }
    }
    PP_STAMP(3 + 2 * l);
  }
  consumers_sync();   // the layer-3 slice is in place

  // layer 4 over K: this block's w3 rows of W4 times its layer-3 slice
  const float* h3 = h1;
  const int n4 = n_out >> 2, nq = R * n4;
  float4 pacc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pacc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; g < st.total; k0 += st.step4, ++g) {
    const float* sw = chunk_wait(g, ring, full);
    const int rows = min(st.step4, st.w3 - k0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + PP_CONSUMERS * q;
      if (idx >= nq) break;
      const int row = idx / n4, j = (idx - row * n4) * 4;
      for (int kk = 0; kk < rows; ++kk) {
        const float hk = h3[(k0 + kk) * R + row];
        const float4 wv = *reinterpret_cast<const float4*>(sw + kk * n_out + j);
        pacc[q].x = fmaf(hk, wv.x, pacc[q].x);
        pacc[q].y = fmaf(hk, wv.y, pacc[q].y);
        pacc[q].z = fmaf(hk, wv.z, pacc[q].z);
        pacc[q].w = fmaf(hk, wv.w, pacc[q].w);
      }
    }
    chunk_done(g, empty, lane);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + PP_CONSUMERS * q;
    if (idx >= nq) break;
    const int row = idx / n4, j = (idx - row * n4) * 4;
    const float* dst = part + ((int)rank * RO + row % RO) * n_out + j;
    st_async(map_rank(dst, (unsigned)(row / RO)), pacc[q], map_rank(pbar, (unsigned)(row / RO)));
  }
  PP_STAMP(8);
  mbar_wait_cluster(pbar, 0);   // every block's partial sums of this block's rows
  PP_STAMP(9);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + PP_CONSUMERS * e;
    if (i >= RO * n_out) break;
    const int rl = i / n_out, n = i - rl * n_out;
    const int row = row0 + (int)rank * RO + rl;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < PP_CLUSTER; ++p) s += part[(p * RO + rl) * n_out + n];
    if (row < a.B) {
      const size_t o = (size_t)row * n_out + n;
      const float v = s + pb[e];
      a.act[o] = v;
      a.tau[o] = a.kp * (v - pq[e]) - a.kd * pv[e];
    }
  }
  PP_STAMP(10);
}

// A net's layout: rows a cluster, slice width, chunk rows, the instance.
typedef void (*PPKernel)(const PPArgs);
struct PPLayout {
  int R, CW, KC;
  PPKernel fn;
};
static PPLayout pp_layout(const int* dims) {
  if (pp_wide(dims)) return {16, 2 * PP_HALF, PP_SLOT / (2 * PP_HALF),
                             policy_pd_kernel<16, 2 * PP_HALF, PP_SLOT / (2 * PP_HALF)>};
  return {PP_ROWS, PP_HALF, PP_SLOT / PP_HALF,
          policy_pd_kernel<PP_ROWS, PP_HALF, PP_SLOT / PP_HALF>};
}

// Dynamic shared memory of a launch: the ring, two activation buffers, the
// partial tiles, the last layer's partial sums and the mbarriers (2 S for
// the ring, 2 x 8 for the slices, 1 for the sums).
extern "C" int policy_pd_smem_bytes(int n_in, int h1, int h2, int h3, int n_out) {
  const int dims[5] = {n_in, h1, h2, h3, n_out};
  const int R = pp_layout(dims).R;
  return (PP_STAGES * PP_SLOT + 2 * pp_act_floats(dims, R) + PP_RED + R * n_out) * 4 +
         (2 * PP_STAGES + 2 * PP_CLUSTER + 1) * 8;
}

// The device's opt-in shared memory a block, read once per device; both
// layouts' kernels are then allowed to take all of it, so a launch needs no
// attribute call of its own.
static cudaError_t pp_smem_optin(int* optin) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev]) {
    *optin = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  for (int wide = 0; wide < 2; ++wide) {
    const int dims[5] = {0, wide ? PP_HMAX : 4, 4, 4, 4};
    err = cudaFuncSetAttribute((const void*)pp_layout(dims).fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) known[dev] = *optin;
  return err;
}

static void pp_cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                              int smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(PP_THREADS);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = PP_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The compiled kernel at these widths: out = (registers a thread, local
// bytes a thread, static shared bytes, dynamic shared bytes, clusters the
// card can hold at once, rows a cluster).
extern "C" int policy_pd_attributes(int n_in, int h1, int h2, int h3, int n_out, int* out) {
  const int dims[5] = {n_in, h1, h2, h3, n_out};
  const PPLayout L = pp_layout(dims);
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, (const void*)L.fn);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = pp_smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const int smem = policy_pd_smem_bytes(n_in, h1, h2, h3, n_out);
  if (smem > optin) return PP_ERR_SMEM;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  pp_cluster_config(&cfg, &attr, PP_CLUSTER, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)L.fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = smem;
  out[4] = clusters;
  out[5] = L.R;
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// W (K x N, row-major fp32) as a tensor map of KC x CW boxes.
static int pp_encode(CUtensorMap* map, const float* W, int K, int N, int CW, int KC) {
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
  const cuuint64_t size[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t stride[1] = {(cuuint64_t)N * 4};
  const cuuint32_t box[2] = {(cuuint32_t)CW, (cuuint32_t)KC};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)W, size, stride, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" int policy_pd_launch(const float* x, const float* qj, const float* vj,
                                const float* W1, const float* b1, const float* W2,
                                const float* b2, const float* W3, const float* b3,
                                const float* W4, const float* b4, float* act,
                                float* tau, int B, int n_in, int h1, int h2,
                                int h3, int n_out, float kp, float kd, void* stream) {
  if (h1 > PP_HMAX || h2 > PP_HMAX || h3 > PP_HMAX || n_out > PP_HALF)
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = pp_smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const int smem = policy_pd_smem_bytes(n_in, h1, h2, h3, n_out);
  if (smem > optin) return PP_ERR_SMEM;
  PPArgs a;
  const float* W[3] = {W1, W2, W3};
  const int dims[5] = {n_in, h1, h2, h3, n_out};
  const PPLayout L = pp_layout(dims);
  for (int l = 0; l < 3; ++l) {
    const int e = pp_encode(&a.map[l], W[l], dims[l], dims[l + 1], L.CW, L.KC);
    if (e) return e;
  }
  a.x = x;
  a.qj = qj;
  a.vj = vj;
  a.W4 = W4;
  a.b[0] = b1;
  a.b[1] = b2;
  a.b[2] = b3;
  a.b[3] = b4;
  a.act = act;
  a.tau = tau;
  a.B = B;
  for (int i = 0; i < 5; ++i) a.dims[i] = dims[i];
  a.kp = kp;
  a.kd = kd;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  pp_cluster_config(&cfg, &attr, ((B + L.R - 1) / L.R) * PP_CLUSTER, smem, stream);
  err = cudaLaunchKernelEx(&cfg, L.fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
