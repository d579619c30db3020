// Gram matrix G = A A^T of a [K, n] float32 client slab, for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the Pallas TPU kernel _gram_kernel (launched by _gram_pallas) of
// federated_pytorch_test_tpu/ops/comm_kernels.py: krum's distance pass under
// --robust-chunked (parallel/comm.py robust_federated_mean_chunked), called
// once per shard with K clients and n = ceil(N / D) coordinates.
//
// What bounds it on this card.  On the path K = 10 and n is up to 2,360,320
// (ResNet18's largest block at D = 2): one call must read K*n*4 B = 94.4 MB
// and do 2*K^2*n = 0.47 GFLOP.  At 3.35 TB/s the read takes 28.2 us, the
// arithmetic 7.0 us at 67 TFLOP/s float32, so the kernel is bound by bytes.
// At the stem block (n = 928) it reads 37 KB (11 ns): launch and host cost
// set its time.  No tensor cores: the product needs 7 us of float32 issue
// against 28 us of bytes, and TF32 would break the tolerance the result is
// held to (1e-5 max G_ii + 1e-6 against a float32 reference).
//
// A thread that loads its own columns has a few bytes in flight and waits a
// full memory latency before each step of arithmetic, and a second launch
// to sum the column chunks costs a launch at the stem.  So:
//   * one launch, persistent blocks.  plan() (ops/gram.py) cuts the columns
//     into at most 132 contiguous chunks (one block per SM), each a whole
//     number of 1,024-column stages.  For K <= 16 a block holds the whole
//     row tile (R = K, a compile-time size, so the K(K+1)/2 upper-triangle
//     accumulators live in registers); for K > 16 the rows are cut into
//     tiles of 8 and a block takes one pair of tiles (ti <= tj) of a chunk.
//   * a ring of 4 shared-memory stages of [R, 1,024] float32 (3 above 12
//     rows), fed by cp.async: while a block multiplies one stage, the next
//     ones are in flight (up to 120 KB a block at K = 10), so the latency is
//     hidden behind the stream.  A thread reads one float4 of each row of a
//     stage from shared memory (conflict-free) and accumulates four columns.
//   * 16-byte copies when every row starts 16-byte aligned (the base pointer
//     and the row stride lda), else 4-byte copies into the same layout: the
//     arithmetic, and so the result, is the same on both paths.  The ragged
//     edge past n is zero-filled by the copy (src-size 0), and adds nothing.
//   * the cross-block sum in the same launch: each block sums its threads
//     (a reduce-scatter over each warp's lanes, then the warps in a fixed
//     order), writes its [K, K] partial to a workspace and takes a ticket
//     from one counter (an acq_rel atomic after a block barrier).  The block that draws the last ticket sums all partials in
//     chunk order, writes G_ij and G_ji (symmetric by construction) and
//     resets the counter to 0 for the next call on the stream.  It first
//     stages every partial in shared memory with all its threads, so the
//     loads overlap and the chunk-order sums read shared memory.  The atomic
//     only elects that block: no value passes through it, and the plan
//     depends on (K, n) only, so G repeats bit for bit from run to run
//     (krum's selection is replayed).  With one chunk the blocks write G
//     directly, with no workspace and no counter.
// Rows of a tile past K read as 0; a zero row gives a zero row and column
// of G.  float32 FMA throughout: no TF32, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4 * kThreads;        // columns of a stage: a float4 a thread
// ring depth: four stages while they fit in 192 KB (up to 12 rows), else three
__host__ __device__ constexpr int stages_for(int rows) { return rows <= 12 ? 4 : 3; }
constexpr int kTiledR = 8;                 // row tile when K > 16
constexpr int kUnroll = 16;                // float4 loads in flight a thread, last block

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Accumulate one column into the upper triangle of an R x R diagonal tile.
template <int R>
__device__ __forceinline__ void acc_diag(float (&acc)[R * (R + 1) / 2], const float (&v)[R]) {
  int k = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = r; s < R; ++s) {
      acc[k] = fmaf(v[r], v[s], acc[k]);
      ++k;
    }
  }
}

template <int R>
__device__ __forceinline__ void acc_full(float (&acc)[R * R], const float (&u)[R],
                                         const float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < R; ++s) acc[r * R + s] = fmaf(u[r], v[s], acc[r * R + s]);
  }
}

// Issue the copies of stage columns [col, col + kCols) of the RS rows
// rows[0..RS) (a row index >= K reads as 0) into one ring slot [RS, kCols].
template <int RS, bool VEC>
__device__ __forceinline__ void issue_stage(float* slot, const float* a, long long lda, int K,
                                           long long n, long long col, const int (&rows)[RS]) {
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const bool live = rows[r] < K;
    const float* src = a + (live ? (long long)rows[r] * lda : 0);
    if (VEC) {
      const long long c = col + 4 * threadIdx.x;
      const long long left = live ? n - c : 0;
      const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
      cp_async16(slot + r * kCols + 4 * threadIdx.x, bytes > 0 ? src + c : a, bytes);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = threadIdx.x + k * kThreads;
        const long long c = col + j;
        const bool in = live && c < n;
        cp_async4(slot + r * kCols + j, in ? src + c : a, in ? 4 : 0);
      }
    }
  }
}

// One step of a reduce-scatter over a warp: lanes o apart swap halves of
// their first 2H values; a lane keeps the upper half where (lane & o) != 0.
template <int H, int N>
__device__ __forceinline__ void rs_step(float (&v)[N], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Sum the block's threads for each accumulator, in a fixed order.  Within a
// warp, a reduce-scatter over the lanes: the NACC sums, padded to NP (a
// multiple of 32), are halved at each of five shuffle steps, so lane L ends
// with sums [L*NP/32, (L+1)*NP/32) (62 shuffles a warp at K = 10, against
// 275 for a shuffle tree per accumulator; the SM shuffles one warp a
// clock).  Then the warps in order, through red (the ring, after the
// stream).  Returns the NACC block sums, in red.
template <int NACC>
__device__ __forceinline__ const float* block_sum(const float (&acc)[NACC], float* red) {
  constexpr int NP = (NACC + 31) / 32 * 32, J = NP / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) v[k] = k < NACC ? acc[k] : 0.f;
  rs_step<NP / 2>(v, lane, 16);
  rs_step<NP / 4>(v, lane, 8);
  rs_step<NP / 8>(v, lane, 4);
  rs_step<NP / 16>(v, lane, 2);
  rs_step<NP / 32>(v, lane, 1);
#pragma unroll
  for (int t = 0; t < J; ++t) red[warp * NP + J * lane + t] = v[t];
  __syncthreads();
  float* sums = red + kWarps * NP;
  for (int t = threadIdx.x; t < NACC; t += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NP + t];
    sums[t] = s;
  }
  __syncthreads();
  return sums;
}

// One ticket from the block's arrival counter: the atomic releases the
// block's partial (its stores precede it through a block barrier) and, for
// the block that draws the last ticket, acquires every other block's.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// The entry (i, j), i <= j, of G that accumulator t of the block's tile
// holds; false if it holds none (past K, or below the diagonal of a
// diagonal tile pair).  Untiled, the accumulators number the upper
// triangle r <= s row-major; tiled, r*R + s.
template <int R, bool TILED>
__device__ __forceinline__ bool entry_of(int t, bool diag, int row0, int col0, int K, int& i,
                                         int& j) {
  int r, q;
  if (!TILED) {
    r = 0;
    int rest = t;
    while (rest >= R - r) {
      rest -= R - r;
      ++r;
    }
    q = r + rest;
  } else {
    r = t / R;
    q = t % R;
    if (diag && r > q) return false;
  }
  i = row0 + r;
  j = col0 + q;
  return i < K && j < K;
}

// grid = (nchunks, tile pairs).  TILED = false: one diagonal tile of R = K
// rows.  TILED = true: R = 8 and blockIdx.y numbers the tile pairs (ti, tj),
// ti <= tj, of T = ceil(K/8) tiles in row-major order; a stage then holds
// both tiles' rows (16, or 8 when ti == tj).
template <int R, bool TILED, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const float* __restrict__ a, long long lda, int K, long long n, long long chunk,
            int T, float* __restrict__ work, unsigned* __restrict__ counter,
            float* __restrict__ g) {
  constexpr int RS = TILED ? 2 * R : R;      // rows a stage holds
  constexpr int kStages = stages_for(RS);
  constexpr int NDIAG = R * (R + 1) / 2;
  extern __shared__ __align__(16) float ring[];
  __shared__ bool last;

  int ti = 0, tj = 0;
  if (TILED) {
    int p = blockIdx.y;
    while (p >= T - ti) {
      p -= T - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const int row0 = ti * R, col0 = tj * R;
  const bool diag = !TILED || ti == tj;
  int rows[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r)
    rows[r] = r < R ? row0 + r : (diag ? K : col0 + r - R);   // K: not loaded

  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = (c0 + chunk < n) ? c0 + chunk : n;
  const int nst = (int)((c1 - c0 + kCols - 1) / kCols);

  constexpr int NACC = TILED ? R * R : NDIAG;
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue_stage<RS, VEC>(ring + s * RS * kCols, a, lda, K, n, c0 + (long long)s * kCols, rows);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();            // stage s has landed (this thread's copies)
    __syncthreads();                          // ... every thread's; slot s-1 is free
    const int nx = s + kStages - 1;
    if (nx < nst)
      issue_stage<RS, VEC>(ring + (nx % kStages) * RS * kCols, a, lda, K, n,
                           c0 + (long long)nx * kCols, rows);
    cp_async_commit();
    const float4* slot = reinterpret_cast<const float4*>(ring + (s % kStages) * RS * kCols);
    float4 x[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) x[r] = slot[r * kThreads + threadIdx.x];
#pragma unroll
    for (int e = 0; e < 4; ++e) {             // the thread's four columns, in order
      float u[R];
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = e == 0 ? x[r].x : e == 1 ? x[r].y : e == 2 ? x[r].z : x[r].w;
      if constexpr (!TILED) {
        acc_diag<R>(acc, u);
      } else {
        // a diagonal tile pair multiplies its rows by themselves (only
        // r <= s is stored); the second tile's rows are then not loaded
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 y = diag ? x[r] : x[R + r];
          v[r] = e == 0 ? y.x : e == 1 ? y.y : e == 2 ? y.z : y.w;
        }
        acc_full<R>(acc, u, v);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const float* sums = block_sum<NACC>(acc, ring);
  const bool direct = gridDim.x == 1;        // one chunk: G directly
  float* dst = direct ? g : work + (long long)blockIdx.x * K * K;
  for (int t = threadIdx.x; t < NACC; t += kThreads) {
    int i, j;
    if (!entry_of<R, TILED>(t, diag, row0, col0, K, i, j)) continue;
    dst[(long long)i * K + j] = sums[t];
    if (direct) dst[(long long)j * K + i] = sums[t];
  }
  if (direct) return;
  __syncthreads();                           // the block's partial is stored
  if (threadIdx.x == 0) last = take_ticket(counter) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  const int nchunks = gridDim.x, kk = K * K, total = nchunks * K * K;
  // the workspace is 16-byte aligned, and so is the ring: float4 copies,
  // kUnroll in flight a thread (one round at K = 10 over 129 chunks)
  const int total4 = total >> 2;
  const float4* w4 = reinterpret_cast<const float4*>(work);
  float4* r4 = reinterpret_cast<float4*>(ring);
  for (int e0 = 0; e0 < total4; e0 += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < total4) v[u] = __ldcg(w4 + e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < total4) r4[e] = v[u];
    }
  }
  for (int e = 4 * total4 + threadIdx.x; e < total; e += kThreads) ring[e] = __ldcg(work + e);
  __syncthreads();
  for (int e = threadIdx.x; e < kk; e += kThreads) {
    const int i = e / K, j = e % K;
    if (i > j) continue;
    float s = 0.f;                           // in chunk order, kUnroll loads ahead
    int c = 0;
    for (; c + kUnroll <= nchunks; c += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = ring[(c + u) * kk + e];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += v[u];
    }
    for (; c < nchunks; ++c) s += ring[c * kk + e];
    g[(long long)i * K + j] = s;
    g[(long long)j * K + i] = s;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

template <int R, bool TILED, bool VEC>
int launch(const float* a, long long lda, int K, long long n, long long chunk, int nchunks,
           float* work, unsigned* counter, float* g, cudaStream_t s) {
  constexpr int RS = TILED ? 2 * R : R;
  constexpr int smem = stages_for(RS) * RS * kCols * (int)sizeof(float);
  static bool attr = false;                  // set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(gram_kernel<R, TILED, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  if (nchunks > 1 && (long long)nchunks * K * K * (long long)sizeof(float) > smem)
    return (int)cudaErrorInvalidValue;      // the partials must fit in the ring
  const int T = TILED ? (K + R - 1) / R : 1;
  gram_kernel<R, TILED, VEC><<<dim3(nchunks, TILED ? T * (T + 1) / 2 : 1), kThreads, smem, s>>>(
      a, lda, K, n, chunk, T, work, counter, g);
  return (int)cudaGetLastError();
}

template <bool VEC>
int dispatch(const float* a, long long lda, int K, long long n, long long chunk, int nchunks,
             float* work, unsigned* counter, float* g, cudaStream_t s) {
  switch (K) {
#define GRAM_SMALL(k) \
  case k:             \
    return launch<k, false, VEC>(a, lda, K, n, chunk, nchunks, work, counter, g, s);
    GRAM_SMALL(1) GRAM_SMALL(2) GRAM_SMALL(3) GRAM_SMALL(4)
    GRAM_SMALL(5) GRAM_SMALL(6) GRAM_SMALL(7) GRAM_SMALL(8)
    GRAM_SMALL(9) GRAM_SMALL(10) GRAM_SMALL(11) GRAM_SMALL(12)
    GRAM_SMALL(13) GRAM_SMALL(14) GRAM_SMALL(15) GRAM_SMALL(16)
#undef GRAM_SMALL
    default:
      return launch<kTiledR, true, VEC>(a, lda, K, n, chunk, nchunks, work, counter, g, s);
  }
}

}  // namespace

extern "C" {

// g [K, K] <- A A^T for A [K, n] float32 with row stride lda (elements; the
// columns are contiguous), in one launch.  chunk is a multiple of 1,024 and
// nchunks = ceil(n / chunk) (ops/gram.py plan).  vec: every row starts
// 16-byte aligned (16-byte copies), else 4-byte copies.  With nchunks > 1,
// work (16-byte aligned) holds nchunks * K * K floats and counter is 0 on
// entry (and again on exit); with one chunk neither is touched.  K in
// [1, 128], n >= 1.  Returns the CUDA error of the launch.
int gram(const float* a, long long lda, int K, long long n, long long chunk, int nchunks,
         int vec, float* work, unsigned* counter, float* g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 128 || n < 1 || chunk < 1 || chunk % kCols != 0 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  return vec ? dispatch<true>(a, lda, K, n, chunk, nchunks, work, counter, g, s)
             : dispatch<false>(a, lda, K, n, chunk, nchunks, work, counter, g, s);
}

}  // extern "C"
