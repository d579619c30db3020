// InfoNCE forward and backward kernels for Hopper (sm_90a), plain C ABI.
//
// Replaces the two Pallas TPU kernels of federated_pytorch_test_tpu/ops/infonce.py:
//   * infonce_fwd  <- _log_p_kernel (via _log_p_pallas):  log_p [P] from Z, Zhat [D, P]
//   * infonce_bwd  <- _grad_kernel  (via _grads_pallas):  dZ, dZhat [D, P] from the
//                     saved log_p and ghat [P]
//
// The math (z_i, zhat_j the columns of Z and Zhat, norms guarded as
// infonce_core.safe_norms: a zero column gets norm 1):
//   zz_ij    = <z_i, zhat_j> / (|z_i| |zhat_j|)
//   log_p_i  = zz_ii - logsumexp_j zz_ij
//   s_ij     = exp(zz_ij - lse_i),  lse_i = zz_ii - log_p_i
//   G_ij     = ghat_i (delta_ij - s_ij),  Gn_ij = G_ij / (|z_i| |zhat_j|)
//   dZ[:,i]    = sum_j Zhat[:,j] Gn_ij + Z[:,i]    * (-sum_j G_ij zz_ij / |z_i|^2)
//   dZhat[:,j] = sum_i Z[:,i]    Gn_ij + Zhat[:,j] * (-sum_i G_ij zz_ij / |zhat_j|^2)
//
// What bounds them on this card.  On the CPC path D = 128*32 = 4096 and
// P = 9: Z and Zhat are 147 KB each.  The forward must read 295 KB (88 ns at
// 3.35 TB/s) and do 0.66 MFLOP (10 ns at 67 TFLOP/s), the backward twice
// that: bytes and operations are far below a microsecond.  The time is
// latency: the launch, one memory round trip, the depth of the reduction
// over D and of the IEEE arithmetic on the P x P scores, and the
// synchronisation between the SMs that share D.  The first design (one block
// of 512 threads per score row: P = 9 blocks on 132 SMs) walked D in 73
// dependent steps of global loads in every block, each block re-reading all
// of Zhat, and the backward took a second launch through a global scratch.
//
// What the design does about it (P <= 32; cluster_plan gives the split):
//   * one launch of one cluster of 16 blocks (the non-portable size: the
//     row-proportional work halves against 8) on neighbouring SMs.  Block r
//     owns the contiguous rows [r*R, (r+1)*R) of D; R is a multiple of 4, so
//     its rows of Z and Zhat are 16-byte aligned and one thread stages them
//     in shared memory with two bulk copies (the TMA engine; 4-byte cp.async
//     copies when a tensor is not aligned), issued before the block's set-up.
//   * the partial sums: warps of 32 lanes per tile of 3 columns i (2 above
//     P = 16); a lane takes every 64th row and accumulates in registers the
//     3 x P cross sums z_di * zhat_dj and |z_i|^2, |zhat_i|^2.  A
//     reduce-scatter over the warp (shuffles) and the sum of a tile's two
//     warps give the block's P x (P + 2) partials, in a fixed order.
//   * the exchange: each block pushes its partials into the shared memory of
//     rank 0 (forward) or of every rank (backward) with one bulk copy a rank
//     (cp.async.bulk shared::cluster), counted by the receiver's mbarrier.
//     The only cluster barriers are relaxed (mbarrier set-up before the
//     pushes, and no block exiting before every push has landed): a barrier
//     with release semantics is a cluster-wide fence, which the pushes do
//     not need.  A receiver sums the ranks' partials in rank order, so in
//     the backward every block holds bitwise the same totals.
//   * forward: rank 0 forms the guarded norms, the scores, the row
//     logsumexp and log_p, a warp a score row.
//   * backward: every block forms G, Gn and the row and column terms
//     redundantly, warp q forming row q and column q (Gn and Gn^T written
//     without a transpose; an entry formed twice is formed by the same
//     operations), then dZ and dZhat for its own rows from the rows still
//     staged in shared memory (restaged when D needs tiles): a thread forms
//     2 rows (1 above P = 12) so each broadcast value of Gn serves both,
//     into shared memory, written out with two bulk copies.
//   * the kernels are compiled for P exactly up to 16 and for P padded to a
//     multiple of 4 above, so the register arrays and loops have the length
//     of the data.  No atomics and no global workspace: the order of every
//     sum depends on (D, P) only, so the results repeat bit for bit.
// Above P = 32 the wrappers take the first design's kernels (the rows
// branch: one block per score row, and a second backward pass over a
// [3P^2 + 2P] scratch): no path reaches it.
// No fast math: expf, logf, sqrtf and division stay IEEE.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;            // threads of a block, both branches
constexpr int kWarps = kThreads / 32;
constexpr int kGradThreads = 256;        // threads of a rows-branch pass-2 block
constexpr int kCluster = 16;             // blocks of the cluster (non-portable size)
constexpr int kClusterMaxP = 32;         // largest P of the cluster branch
constexpr int kStageBytes = 128 * 1024;  // shared memory for the staged row tiles
constexpr int kSmemLimit = 232448;       // shared memory a block may use (227 KB)
constexpr int kMaxDevices = 64;          // devices whose kernel attributes are kept

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float safe_norm(float sq) {
  return sqrtf(sq == 0.f ? 1.f : sq);
}

// ---------------------------------------------------------------------------
// Cluster branch (P <= 32)
// ---------------------------------------------------------------------------

// Columns i of Z a thread accumulates the cross sums of (a register tile).
__host__ __device__ constexpr int tile_cols(int PS) { return PS <= 16 ? 3 : 2; }
// Floats of a column's partials: the P cross sums at [0, P), |z_i|^2 at PS
// and |zhat_i|^2 at PS + 1, padded to a 16-byte row.
__host__ __device__ constexpr int part_row(int PS) { return PS + 4; }

// Shared memory of a cluster block in floats (ops/infonce.py
// cluster_smem_bytes models the same for its tests):
//   zs, hs, oz, oh [tile_rows][P]  staged rows of Z, Zhat, dZ and dZhat, as
//                                  in memory (each padded to a multiple of 4
//                                  floats: 16-byte aligned)
//   recv [C][P][W]                 every rank's partials, pushed by the ranks
//   part, tot [P][W]               this block's partials, the cluster's totals
//   gn, gnt [P][PS]                Gn and Gn^T (backward; columns >= P zero)
//   red [16][3][PS+2]              each warp's sums of its lanes' partials
//   rowterm, colterm, lp, gh [P]
//   two mbarriers                  staging, and the partials' arrival (4
//                                  floats and 8-byte alignment)
__host__ __device__ constexpr long long cluster_smem_floats(int P, int tile_rows) {
  return 4LL * ((tile_rows * P + 3) / 4 * 4) +
         (kCluster + 2LL) * P * part_row((P + 3) / 4 * 4) + 2LL * P * ((P + 3) / 4 * 4) +
         kWarps * 3LL * ((P + 3) / 4 * 4 + 2) + 4LL * P + 5;
}

// The cluster kernels' split of [D, P], a function of (D, P) alone, so the
// order of every sum repeats from run to run (ops/infonce.py plan models
// it): block r owns the rows [r R, (r + 1) R) of D, R a multiple of 4 so a
// block's rows start 16-byte aligned whenever the tensor does, and stages
// them tile_rows at a time.
struct ClusterPlan {
  long long rows_per_block;
  int tile_rows;
  size_t smem;
};

ClusterPlan cluster_plan(long long D, int P) {
  ClusterPlan p;
  p.rows_per_block = (D + 4LL * kCluster - 1) / (4LL * kCluster) * 4;
  const int stage = kStageBytes / (16 * P) / 4 * 4;
  p.tile_rows = (int)(p.rows_per_block < stage ? p.rows_per_block : stage);
  p.smem = (size_t)cluster_smem_floats(P, p.tile_rows) * 4;
  return p;
}

struct Smem {
  float *zs, *hs, *oz, *oh, *recv, *part, *tot, *gn, *gnt, *red, *rowterm, *colterm, *lp, *gh;
  uint64_t *stage_bar, *recv_bar;
};

template <int PS>
__device__ __forceinline__ Smem carve(float* s, int P, int tile_rows) {
  const int V = P * part_row(PS), rows = (tile_rows * P + 3) / 4 * 4;
  Smem m;
  m.zs = s;                                // every region 16-byte aligned
  m.hs = m.zs + rows;
  m.oz = m.hs + rows;
  m.oh = m.oz + rows;
  m.recv = m.oh + rows;
  m.part = m.recv + kCluster * V;
  m.tot = m.part + V;
  m.gn = m.tot + V;
  m.gnt = m.gn + P * PS;
  m.red = m.gnt + P * PS;
  m.rowterm = m.red + kWarps * 3 * (PS + 2);
  m.colterm = m.rowterm + P;
  m.lp = m.colterm + P;
  m.gh = m.lp + P;
  const uintptr_t b = reinterpret_cast<uintptr_t>(m.gh + P);
  m.stage_bar = reinterpret_cast<uint64_t*>((b + 7) & ~uintptr_t(7));
  m.recv_bar = m.stage_bar + 1;
  return m;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Wait for phase `parity` of a shared-memory mbarrier.  A wait that has not
// completed after about a second traps (a launch failure the wrapper
// reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// The cluster barrier, relaxed: it orders no memory (the partials travel with
// their own mbarrier), so it costs no cluster-wide fence.  Every thread of
// the cluster arrives once and then waits once per phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Whether rows [row0, row0 + n) of Z and Zhat go in one bulk copy each: both
// sources 16-byte aligned and n*P a multiple of 4.
__device__ __forceinline__ bool bulk_ok(const float* a, const float* b, int total) {
  return total % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// One thread: the bulk copies of `total` floats of Z and Zhat into zs, hs,
// counted by the staging mbarrier.  The fence orders the block's earlier
// accesses of the buffers and of the mbarrier before the copies.
__device__ __forceinline__ void issue_stage(const Smem& m, const float* zsrc, const float* hsrc,
                                            int total) {
  const unsigned bar = smem_addr(m.stage_bar), bytes = (unsigned)total * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(2u * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(m.zs)), "l"(zsrc), "r"(bytes), "r"(bar) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(m.hs)), "l"(hsrc), "r"(bytes), "r"(bar) : "memory");
}

// Stage rows [row0, row0 + n) of Z and Zhat into zs, hs [n][P], as they lie in
// memory: one thread issues two bulk copies (the TMA engine moves them, the
// block waits on the staging mbarrier), or, off alignment, every thread
// issues 4-byte cp.async copies, all before the first wait.  `issued`: thread
// 0 has already issued this tile's bulk copies.  `phase` counts the bulk
// copies so far.  Ends in a block barrier.
__device__ void stage(const Smem& m, const float* __restrict__ Z, const float* __restrict__ Zh,
                      long long row0, int n, int P, unsigned* phase, bool issued) {
  const float* zsrc = Z + row0 * P;
  const float* hsrc = Zh + row0 * P;
  const int total = n * P;
  if (bulk_ok(zsrc, hsrc, total)) {
    if (threadIdx.x == 0 && !issued) issue_stage(m, zsrc, hsrc, total);
    mbar_wait(m.stage_bar, *phase & 1u);
    ++*phase;
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      cp_async4(m.zs + e, zsrc + e);
      cp_async4(m.hs + e, hsrc + e);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
}

// Thread 0 sets up the staging mbarrier and issues the first tile's bulk
// copies at once, so they are in flight while the block sets up.  After the
// block barrier the last warp (free of the partial sums up to P = 24) sets
// up the partials' mbarrier (expecting `recv_bytes`; 0: this block receives
// nothing) and makes it visible to the cluster, so the other threads do not
// wait for that fence.  Every thread then arrives on the cluster barrier: a
// rank pushes into another only after the matching wait.  Returns whether
// the first tile's copies were issued.
__device__ bool init_block(const Smem& m, const float* Z, const float* Zh, long long row0,
                           int n0, int P, unsigned recv_bytes) {
  const bool bulk = n0 > 0 && bulk_ok(Z + row0 * P, Zh + row0 * P, n0 * P);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(m.stage_bar))
                 : "memory");
    if (bulk) issue_stage(m, Z + row0 * P, Zh + row0 * P, n0 * P);
  }
  __syncthreads();
  if (threadIdx.x == kThreads - 32) {
    const unsigned rb = smem_addr(m.recv_bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(rb) : "memory");
    if (recv_bytes)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(rb),
                   "r"(recv_bytes) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
  return bulk;
}

// One step of a reduce-scatter over a warp: the lane's list v[0, LEN) is cut
// in halves of H = ceil(LEN / 2); the lane with bit `o` clear keeps the lower
// half and the other the upper one, each adding its partner's copy.
// [base, base + valid) tracks the original indices the lane's list holds.
template <int N, int LEN>
__device__ __forceinline__ void rs_step(float (&v)[N], int o, int lane, int& base, int& valid) {
  constexpr int H = (LEN + 1) / 2;
  const bool upper = (lane & o) != 0;
#pragma unroll
  for (int q = 0; q < H; ++q) {
    const float lo = v[q], hi = q + H < LEN ? v[q + H] : 0.f;
    const float got = __shfl_xor_sync(kFull, upper ? lo : hi, o);
    v[q] = (upper ? hi : lo) + got;
  }
  if (upper) {
    base += H;
    valid = valid > H ? valid - H : 0;
  } else {
    valid = valid < H ? valid : H;
  }
}

// The block's partials into m.part [P][W].  The warps form groups of WT per
// column tile (at most 2: more warps add more to the reduction than they
// take from the walk over the rows); lane s of warp w of a tile's group
// takes the rows 32 w + s, 32 w + s + 32 WT, ... of each staged tile and
// accumulates in registers the cross sums z_di * zhat_dj of the tile's TI
// columns i in [TI it, TI it + TI) with every j, and |z_i|^2 and
// |zhat_i|^2.  A reduce-scatter over the warp sums its lanes; the WT warps'
// sums are then added in warp order — a fixed order, the same in every
// block.  Leaves the last tile staged in m.zs, m.hs.
template <int PB>
__device__ void block_partials(const Smem& m, const float* __restrict__ Z,
                               const float* __restrict__ Zh, long long row0, long long nrows,
                               int P, int tile_rows, unsigned* phase, bool issued) {
  constexpr int PS = (PB + 3) / 4 * 4, TI = tile_cols(PS), N = TI * (PB + 2), W = part_row(PS);
  const int tiles = (P + TI - 1) / TI, WT = kWarps / tiles < 2 ? kWarps / tiles : 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int it = warp / WT, sub = warp - it * WT, i0 = TI * it;
  const bool live = it < tiles;            // warp-uniform
  float v[N];                              // [TI][PB] cross sums, [TI] |z|^2, [TI] |zhat|^2
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = 0.f;
  for (long long t0 = 0; t0 < nrows; t0 += tile_rows) {
    const int n = (int)(nrows - t0 < tile_rows ? nrows - t0 : tile_rows);
    if (t0 > 0) __syncthreads();           // the previous tile is consumed
    stage(m, Z, Zh, row0 + t0, n, P, phase, t0 == 0 && issued);
    if (!live) continue;
    for (int r = 32 * sub + lane; r < n; r += 32 * WT) {
      const float* zr = m.zs + r * P;
      const float* hr = m.hs + r * P;
      float zi[TI], hi[TI];
#pragma unroll
      for (int u = 0; u < TI; ++u) {
        zi[u] = i0 + u < P ? zr[i0 + u] : 0.f;
        hi[u] = i0 + u < P ? hr[i0 + u] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < PB; ++j)
        if (j < P) {
          const float h = hr[j];
#pragma unroll
          for (int u = 0; u < TI; ++u) v[u * PB + j] = fmaf(zi[u], h, v[u * PB + j]);
        }
#pragma unroll
      for (int u = 0; u < TI; ++u) {
        v[TI * PB + u] = fmaf(zi[u], zi[u], v[TI * PB + u]);
        v[TI * PB + TI + u] = fmaf(hi[u], hi[u], v[TI * PB + TI + u]);
      }
    }
  }
  if (live) {
    int base = 0, valid = N;               // this lane's sums: indices [base, base + valid)
    constexpr int L1 = (N + 1) / 2, L2 = (L1 + 1) / 2, L3 = (L2 + 1) / 2, L4 = (L3 + 1) / 2,
                  L5 = (L4 + 1) / 2;
    rs_step<N, N>(v, 16, lane, base, valid);
    rs_step<N, L1>(v, 8, lane, base, valid);
    rs_step<N, L2>(v, 4, lane, base, valid);
    rs_step<N, L3>(v, 2, lane, base, valid);
    rs_step<N, L4>(v, 1, lane, base, valid);
#pragma unroll
    for (int q = 0; q < L5; ++q)
      if (q < valid) m.red[warp * N + base + q] = v[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tiles * N; e += kThreads) {
    const int t = e / N, k = e - t * N;    // [TI][PB] cross sums, [TI] |z|^2, [TI] |zhat|^2
    const int u = k < TI * PB ? k / PB : (k - TI * PB) % TI;
    const int j = k < TI * PB ? k - u * PB : PS + (k - TI * PB) / TI;
    if (TI * t + u < P && (j < P || j >= PS)) {
      float sum = 0.f;
      for (int w = 0; w < WT; ++w) sum += m.red[(t * WT + w) * N + k];
      m.part[(TI * t + u) * W + j] = sum;
    }
  }
  __syncthreads();
}

// Push m.part [P][W] into recv[this rank] of the first `ndest` ranks: one
// bulk copy a rank (the TMA engine moves it between the blocks' shared
// memories), each counted by the destination's mbarrier.  Waits first until
// every rank's mbarriers are set up.
template <int PS>
__device__ void push_part(cg::cluster_group& cl, const Smem& m, int P, int ndest) {
  const unsigned bytes = (unsigned)(P * part_row(PS)) * 4u;
  cluster_wait();
  if (threadIdx.x < ndest) {
    unsigned dst, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst) : "r"(smem_addr(m.recv) + cl.block_rank() * bytes), "r"(threadIdx.x));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(bar) : "r"(smem_addr(m.recv_bar)), "r"(threadIdx.x));
    // the block's writes of m.part before the copy's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst), "r"(smem_addr(m.part)), "r"(bytes), "r"(bar) : "memory");
  }
}

// m.tot <- the sum over the ranks, in rank order, of the partials pushed into
// m.recv: every block that calls it gets the same bits.  Arrives on the
// cluster barrier once every push into this block has landed.
template <int PS>
__device__ void rank_totals(const Smem& m, int P) {
  mbar_wait(m.recv_bar, 0);
  cluster_arrive();
  const int V = P * part_row(PS);
  for (int k = threadIdx.x; k < V; k += kThreads) {
    float t = 0.f;
    for (int r = 0; r < kCluster; ++r) t += m.recv[r * V + k];
    m.tot[k] = t;
  }
  __syncthreads();
}

// The rows of D block `rank` owns: [row0, row0 + nrows), nrows 0 past D.
__device__ __forceinline__ void block_rows(long long D, long long rows_per_block, int rank,
                                           long long* row0, long long* nrows) {
  *row0 = (long long)rank * rows_per_block;
  const long long left = D - *row0;
  *nrows = left <= 0 ? 0 : (left < rows_per_block ? left : rows_per_block);
}

// The kernels are compiled for P = PB exactly up to 16 (the compiler then
// knows every loop's length: 8% off the forward's and 18% off the
// backward's time at P = 9 against PB = 12, PERF.md) and for P padded to PB,
// a multiple of 4, above.
template <int PB>
__global__ void __launch_bounds__(kThreads, 1)
infonce_fwd_cluster(const float* __restrict__ Z, const float* __restrict__ Zh,
                    float* __restrict__ log_p, long long D, int P_in, long long rows_per_block,
                    int tile_rows) {
  constexpr int PS = (PB + 3) / 4 * 4, W = part_row(PS);
  const int P = PB <= 16 ? PB : P_in;
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const Smem m = carve<PS>(reinterpret_cast<float*>(smem4), P, tile_rows);
  long long row0, nrows;
  block_rows(D, rows_per_block, rank, &row0, &nrows);
  unsigned phase = 0;
  const bool issued = init_block(m, Z, Zh, row0, (int)(nrows < tile_rows ? nrows : tile_rows), P,
                                 rank == 0 ? (unsigned)(kCluster * P * W * 4) : 0u);
  block_partials<PB>(m, Z, Zh, row0, nrows, P, tile_rows, &phase, issued);
  push_part<PS>(cl, m, P, 1);
  if (rank == 0) {
    rank_totals<PS>(m, P);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < P; i += kWarps) {   // a warp a score row, a lane a column
      const float zn = safe_norm(m.tot[i * W + PS]);
      const float zz =
          lane < P ? m.tot[i * W + lane] / (zn * safe_norm(m.tot[lane * W + PS + 1])) : -INFINITY;
      const float mx = warp_max(zz);
      const float e = warp_sum(lane < P ? expf(zz - mx) : 0.f);
      const float diag = __shfl_sync(kFull, zz, i);
      if (lane == 0) log_p[i] = diag - (mx + logf(e));
    }
  } else {
    cluster_arrive();
  }
  cluster_wait();                          // rank 0 has every push: none is in flight
}

// Write the staged output tiles oz, oh [total] to dz, dzh: when both are
// 16-byte aligned and total a multiple of 4, one thread issues two bulk
// copies (the TMA engine writes them out) and waits until they have read
// shared memory; else the block writes them out coalesced.  Ends in a
// block barrier, so the tiles may be written again.
__device__ void store_tile(const Smem& m, float* dz, float* dzh, int total) {
  if (bulk_ok(dz, dzh, total)) {
    if (threadIdx.x == 0) {
      const unsigned bytes = (unsigned)total * 4u;
      // the block's writes of the tiles before the copies' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dz),
                   "r"(smem_addr(m.oz)), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dzh),
                   "r"(smem_addr(m.oh)), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      dz[e] = m.oz[e];
      dzh[e] = m.oh[e];
    }
  }
  __syncthreads();
}

template <int PB>
__global__ void __launch_bounds__(kThreads, 1)
infonce_bwd_cluster(const float* __restrict__ Z, const float* __restrict__ Zh,
                    const float* __restrict__ log_p, const float* __restrict__ ghat,
                    float* __restrict__ dZ, float* __restrict__ dZh, long long D, int P_in,
                    long long rows_per_block, int tile_rows) {
  constexpr int PS = (PB + 3) / 4 * 4, W = part_row(PS);
  const int P = PB <= 16 ? PB : P_in;
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const Smem m = carve<PS>(reinterpret_cast<float*>(smem4), P, tile_rows);
  float lpv = 0.f, ghv = 0.f;              // in flight while the rows stage
  if (threadIdx.x < P) {
    lpv = log_p[threadIdx.x];
    ghv = ghat[threadIdx.x];
  }
  long long row0, nrows;
  block_rows(D, rows_per_block, (int)cl.block_rank(), &row0, &nrows);
  unsigned phase = 0;
  const bool issued = init_block(m, Z, Zh, row0, (int)(nrows < tile_rows ? nrows : tile_rows), P,
                                 (unsigned)(kCluster * P * W * 4));
  block_partials<PB>(m, Z, Zh, row0, nrows, P, tile_rows, &phase, issued);
  if (threadIdx.x < P) {
    m.lp[threadIdx.x] = lpv;
    m.gh[threadIdx.x] = ghv;
  }
  push_part<PS>(cl, m, P, kCluster);
  rank_totals<PS>(m, P);                   // every block, rank order: the same bits

  // Warp q forms row q and column q of G (lanes: the other index), so Gn and
  // Gn^T are written without a transpose and the row and column sums of G*zz
  // are warp sums; an entry formed in both is formed by the same operations.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < P; q += kWarps) {
    const bool live = lane < P;
    const int l = live ? lane : q;
    const float zq = safe_norm(m.tot[q * W + PS]), hq = safe_norm(m.tot[q * W + PS + 1]);
    const float zl = safe_norm(m.tot[l * W + PS]), hl = safe_norm(m.tot[l * W + PS + 1]);
    const float dr = zq * hl, dc = zl * hq;
    const float zzr = m.tot[q * W + l] / dr;                     // zz_ql
    const float zzc = m.tot[l * W + q] / dc;                     // zz_lq
    const float lser = m.tot[q * W + q] / (zq * hq) - m.lp[q];   // the forward's residual identity
    const float lsec = m.tot[l * W + l] / (zl * hl) - m.lp[l];
    const float dl = l == q ? 1.f : 0.f;
    const float Gr = m.gh[q] * (dl - expf(zzr - lser));         // G_ql
    const float Gc = m.gh[l] * (dl - expf(zzc - lsec));         // G_lq
    const float rs = warp_sum(live ? Gr * zzr : 0.f);
    const float cs = warp_sum(live ? Gc * zzc : 0.f);
    if (lane < PS) {
      m.gn[q * PS + lane] = live ? Gr / dr : 0.f;               // Gn_ql
      m.gnt[q * PS + lane] = live ? Gc / dc : 0.f;              // Gn_lq
    }
    if (lane == 0) {
      m.rowterm[q] = -rs / (zq * zq);
      m.colterm[q] = -cs / (hq * hq);
    }
  }
  __syncthreads();

  // dZ, dZhat: a thread forms RB rows r0, r0 + T, ... at once (T threads,
  // rows in registers), so each value of Gn and Gn^T it reads — the same for
  // every lane of the warp — serves RB rows; r0 then steps by RB T, so the
  // tile's rows are formed once each.  The rows go to oz, oh and out in
  // bulk.  RB = 2 while the rows fit the 128 registers a thread has, else 1.
  constexpr int RB = PB <= 12 ? 2 : 1;
  const bool restage = nrows > tile_rows;  // else the only tile is still staged
  for (long long t0 = 0; t0 < nrows; t0 += tile_rows) {
    const int n = (int)(nrows - t0 < tile_rows ? nrows - t0 : tile_rows);
    if (restage) stage(m, Z, Zh, row0 + t0, n, P, &phase, false);
    const int want = ((n + RB - 1) / RB + 31) / 32 * 32;   // whole warps
    const int T = want < kThreads ? want : kThreads;
    for (int r0 = threadIdx.x; r0 < n; r0 += RB * T) {
      if (threadIdx.x >= T) break;
      float z[RB][PB], h[RB][PB];
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = r0 + k * T;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          z[k][j] = r < n && j < P ? m.zs[r * P + j] : 0.f;
          h[k][j] = r < n && j < P ? m.hs[r * P + j] : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < PB; ++c) {
        if (c >= P) break;
        float a[RB], b[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) a[k] = b[k] = 0.f;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          if (j >= P) break;
          const float x = m.gn[c * PS + j], y = m.gnt[c * PS + j];
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            a[k] = fmaf(h[k][j], x, a[k]);
            b[k] = fmaf(z[k][j], y, b[k]);
          }
        }
        const float rt = m.rowterm[c], ct = m.colterm[c];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int r = r0 + k * T;
          if (r < n) {
            m.oz[r * P + c] = a[k] + z[k][c] * rt;
            m.oh[r * P + c] = b[k] + h[k][c] * ct;
          }
        }
      }
    }
    __syncthreads();
    store_tile(m, dZ + (row0 + t0) * P, dZh + (row0 + t0) * P, n * P);
  }
  cluster_wait();                          // every block has every push: none in flight
}

// Launch one cluster of kCluster blocks.  The kernel's attributes (the
// dynamic shared memory above 48 KB, the non-portable cluster size) hold for
// the current device only, so they are set once per device and kernel.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), size_t smem, cudaStream_t s,
                   bool (&attr_set)[kMaxDevices], Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch's error
  return (int)(e != cudaSuccess ? e : last);
}

template <int PB>
int fwd_cluster(const float* Z, const float* Zh, float* log_p, long long D, int P,
                const ClusterPlan& pl, cudaStream_t s) {
  static bool attr_set[kMaxDevices] = {};
  return launch_cluster(infonce_fwd_cluster<PB>, pl.smem, s, attr_set, Z, Zh, log_p, D, P,
                        pl.rows_per_block, pl.tile_rows);
}

template <int PB>
int bwd_cluster(const float* Z, const float* Zh, const float* log_p, const float* ghat,
                float* dZ, float* dZh, long long D, int P, const ClusterPlan& pl,
                cudaStream_t s) {
  static bool attr_set[kMaxDevices] = {};
  return launch_cluster(infonce_bwd_cluster<PB>, pl.smem, s, attr_set, Z, Zh, log_p, ghat, dZ,
                        dZh, D, P, pl.rows_per_block, pl.tile_rows);
}

// The cluster branch's plan of [D, P], or false for a shape it does not take.
bool cluster_plan_ok(long long D, int P, ClusterPlan* pl) {
  if (D < 1 || P < 1 || P > kClusterMaxP) return false;
  *pl = cluster_plan(D, P);
  return pl->smem <= (size_t)kSmemLimit;
}

// ---------------------------------------------------------------------------
// Rows branch (P > 32): one block per score row; the backward in two passes.
// ---------------------------------------------------------------------------

// Sum over the block, returned to every thread; fixed order.  `red` holds at
// least kWarps floats and may be reused right after the call.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < kWarps ? red[lane] : -INFINITY);
}

// Score row i: srow[j] = zz_ij for j < P (shared memory), zhn[j] = |zhat_j|
// when zhn is not null.  Returns |z_i|.  `red` holds 2*kThreads floats.  The
// threads form a [nslot x TJ] grid over (rows of D, columns j), TJ =
// min(P, kThreads); the slot partials are summed per column in a fixed order.
__device__ float row_scores(const float* __restrict__ Z, const float* __restrict__ Zh,
                            int64_t D, int P, int i, float* srow, float* zhn,
                            float* red) {
  float sq = 0.f;
  for (int64_t d = threadIdx.x; d < D; d += kThreads) {
    const float v = Z[d * P + i];
    sq = fmaf(v, v, sq);
  }
  const float zn = safe_norm(block_sum(sq, red));

  const int TJ = P < kThreads ? P : kThreads;
  const int nslot = kThreads / TJ;
  const int jl = threadIdx.x % TJ, slot = threadIdx.x / TJ;
  float* part_dot = red;
  float* part_sq = red + kThreads;
  for (int j0 = 0; j0 < P; j0 += TJ) {
    const int j = j0 + jl;
    const bool valid = slot < nslot && j < P;
    float dot = 0.f, hsq = 0.f;
    if (valid) {
#pragma unroll 4
      for (int64_t d = slot; d < D; d += nslot) {
        const float zi = Z[d * P + i];
        const float h = Zh[d * P + j];
        dot = fmaf(zi, h, dot);
        hsq = fmaf(h, h, hsq);
      }
    }
    __syncthreads();                            // red is free again
    part_dot[threadIdx.x] = dot;
    part_sq[threadIdx.x] = hsq;
    __syncthreads();
    if (threadIdx.x < TJ && j0 + (int)threadIdx.x < P) {
      float sd = 0.f, sh = 0.f;
      for (int s = 0; s < nslot; ++s) {         // fixed order over slots
        sd += part_dot[s * TJ + threadIdx.x];
        sh += part_sq[s * TJ + threadIdx.x];
      }
      const float hn = safe_norm(sh);
      srow[j0 + threadIdx.x] = sd / (zn * hn);
      if (zhn != nullptr) zhn[j0 + threadIdx.x] = hn;
    }
  }
  __syncthreads();
  return zn;
}

// Forward: one block per score row i.  Dynamic shared memory: P floats.
__global__ void __launch_bounds__(kThreads)
infonce_fwd_rows_kernel(const float* __restrict__ Z, const float* __restrict__ Zh,
                        float* __restrict__ log_p, int64_t D, int P) {
  extern __shared__ float smem[];
  __shared__ float red[2 * kThreads];
  const int i = blockIdx.x;
  float* srow = smem;
  row_scores(Z, Zh, D, P, i, srow, nullptr, red);

  float m = -INFINITY;
  for (int j = threadIdx.x; j < P; j += kThreads) m = fmaxf(m, srow[j]);
  m = block_max(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < P; j += kThreads) s += expf(srow[j] - m);
  s = block_sum(s, red);
  if (threadIdx.x == 0) log_p[i] = srow[i] - (m + logf(s));
}

// Backward pass 1: one block per score row i.  Writes row i of Gn and GZ
// (= G*zz), column i of GnT, rowterm[i]; block 0 also writes zhn.
// Dynamic shared memory: 2P floats.
__global__ void __launch_bounds__(kThreads)
infonce_bwd_rows_kernel(const float* __restrict__ Z, const float* __restrict__ Zh,
                        const float* __restrict__ log_p, const float* __restrict__ ghat,
                        int64_t D, int P, float* __restrict__ Gn, float* __restrict__ GnT,
                        float* __restrict__ GZ, float* __restrict__ rowterm,
                        float* __restrict__ zhn_out) {
  extern __shared__ float smem[];
  __shared__ float red[2 * kThreads];
  const int i = blockIdx.x;
  float* srow = smem;
  float* zhn = smem + P;
  const float zn = row_scores(Z, Zh, D, P, i, srow, zhn, red);

  const float lse = srow[i] - log_p[i];         // the forward's residual identity
  const float gi = ghat[i];
  float acc = 0.f;
  for (int j = threadIdx.x; j < P; j += kThreads) {
    const float zz = srow[j];
    const float G = gi * ((j == i ? 1.f : 0.f) - expf(zz - lse));
    const float gn = G / (zn * zhn[j]);
    Gn[(int64_t)i * P + j] = gn;
    GnT[(int64_t)j * P + i] = gn;
    const float gz = G * zz;
    GZ[(int64_t)i * P + j] = gz;
    acc += gz;
    if (i == 0) zhn_out[j] = zhn[j];
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) rowterm[i] = -acc / (zn * zn);
}

// Backward pass 2: one thread per element (d, c) of dZ and dZhat.
__global__ void __launch_bounds__(kGradThreads)
infonce_bwd_grads_kernel(const float* __restrict__ Z, const float* __restrict__ Zh,
                         const float* __restrict__ Gn, const float* __restrict__ GnT,
                         const float* __restrict__ GZ, const float* __restrict__ rowterm,
                         const float* __restrict__ zhn, int64_t D, int P,
                         float* __restrict__ dZ, float* __restrict__ dZh) {
  const int64_t e = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  if (e >= D * P) return;
  const int64_t d = e / P;
  const int c = (int)(e - d * P);
  const float* zrow = Z + d * P;
  const float* hrow = Zh + d * P;
  float a = 0.f, b = 0.f, col = 0.f;
  for (int j = 0; j < P; ++j) {                 // fixed order over j (and i)
    a = fmaf(hrow[j], GnT[(int64_t)j * P + c], a);   // sum_j Zhat[d,j] Gn[c,j]
    b = fmaf(zrow[j], Gn[(int64_t)j * P + c], b);    // sum_i Z[d,i] Gn[i,c]
    col += GZ[(int64_t)j * P + c];                    // sum_i G_ic zz_ic
  }
  const float hn = zhn[c];
  dZ[e] = a + zrow[c] * rowterm[c];
  dZh[e] = b + hrow[c] * (-col / (hn * hn));
}

}  // namespace

// P of the cluster kernels: exactly 1..16, then P padded to a multiple of 4
#define INFONCE_PB_CASES(X)                                                                 \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)   \
  X(20) X(24) X(28) X(32)

extern "C" {

// log_p [P] <- Z, Zh [D, P] row-major float32, in one launch: the cluster
// branch (P <= 32), or with rows != 0 the rows branch.  Returns the CUDA
// error of the launch (cudaErrorInvalidValue for a shape the branch does
// not take).
int infonce_fwd(const float* Z, const float* Zh, float* log_p, long long D, int P, int rows,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows) {
    if (D < 1 || P < 1) return (int)cudaErrorInvalidValue;
    infonce_fwd_rows_kernel<<<P, kThreads, (size_t)P * sizeof(float), s>>>(Z, Zh, log_p, D, P);
    return (int)cudaGetLastError();
  }
  ClusterPlan pl;
  if (!cluster_plan_ok(D, P, &pl)) return (int)cudaErrorInvalidValue;
  switch (P <= 16 ? P : (P + 3) / 4 * 4) {
#define FWD_CASE(pb)                                                                        \
  case pb:                                                                                  \
    return fwd_cluster<pb>(Z, Zh, log_p, D, P, pl, s);
    INFONCE_PB_CASES(FWD_CASE)
#undef FWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// dZ, dZh [D, P] <- Z, Zh [D, P], log_p, ghat [P].  The cluster branch is one
// launch and takes no scratch (pass null).  The rows branch (rows != 0) is
// two launches through scratch, 3*P*P + 2*P floats.  Returns the CUDA error
// of the launch.
int infonce_bwd(const float* Z, const float* Zh, const float* log_p, const float* ghat,
                float* dZ, float* dZh, float* scratch, long long D, int P, int rows,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows) {
    if (D < 1 || P < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int64_t PP = (int64_t)P * P;
    float* Gn = scratch;
    float* GnT = Gn + PP;
    float* GZ = GnT + PP;
    float* rowterm = GZ + PP;
    float* zhn = rowterm + P;
    infonce_bwd_rows_kernel<<<P, kThreads, 2 * (size_t)P * sizeof(float), s>>>(
        Z, Zh, log_p, ghat, D, P, Gn, GnT, GZ, rowterm, zhn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t n = (int64_t)D * P;
    const unsigned blocks = (unsigned)((n + kGradThreads - 1) / kGradThreads);
    infonce_bwd_grads_kernel<<<blocks, kGradThreads, 0, s>>>(
        Z, Zh, Gn, GnT, GZ, rowterm, zhn, D, P, dZ, dZh);
    return (int)cudaGetLastError();
  }
  ClusterPlan pl;
  if (!cluster_plan_ok(D, P, &pl)) return (int)cudaErrorInvalidValue;
  switch (P <= 16 ? P : (P + 3) / 4 * 4) {
#define BWD_CASE(pb)                                                                        \
  case pb:                                                                                  \
    return bwd_cluster<pb>(Z, Zh, log_p, ghat, dZ, dZh, D, P, pl, s);
    INFONCE_PB_CASES(BWD_CASE)
#undef BWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
