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
// At the stem block (n = 928) it reads 37 KB and launch latency sets its time.
//
// What the design does about it.  Every element of A is read from device
// memory once, by one thread, with neighbouring threads on neighbouring
// columns (coalesced), and every product is formed in registers:
//   * pass 1 (gram_partial_kernel): block (c, p) takes the columns
//     [c*chunk, (c+1)*chunk) and the row-tile pair p.  For K <= 16 there is one
//     tile of R = K rows (a compile-time size, so the K(K+1)/2 accumulators
//     of the upper triangle live in registers); for K > 16 the rows are cut
//     into tiles of R = 8 and the block takes one pair of tiles (ti <= tj).
//     Each thread walks its columns and accumulates; the block then sums its
//     threads (warp shuffles, then the warps in a fixed order) and writes its
//     [K, K] partial (upper triangle only) to a workspace.
//   * pass 2 (gram_reduce_kernel): one thread per entry i <= j sums the
//     partials of all column chunks in chunk order and writes G_ij and G_ji,
//     so the output is symmetric by construction.
// The Pallas kernel accumulates one output block across its grid steps,
// which is correct only because a TPU grid runs in order.  A CUDA grid runs
// in no order, so the contraction is split over blocks and summed in a
// second pass, with no atomics: the chunking depends on (K, n) only, and the
// result repeats bit for bit from run to run (krum's selection is replayed).
// Rows of a tile past K are never loaded; a zero row gives a zero row and
// column of G.  float32 FMA throughout: no TF32, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiledR = 8;                 // row tile when K > 16

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

// Load column c of the R rows starting at row0; rows at or past K read 0.
template <int R>
__device__ __forceinline__ void load_col(float (&v)[R], const float* __restrict__ a, long long lda,
                                         int row0, int K, long long c) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = (row0 + r < K) ? __ldg(a + (long long)(row0 + r) * lda + c) : 0.f;
}

// Sum the block's threads for each accumulator and write entry
// (row0 + r, col0 + s) of this chunk's partial.  ``diag`` numbers the
// accumulators over the upper triangle r <= s (row-major), else r*R + s.
template <int R, int NACC>
__device__ __forceinline__ void block_store(const float (&acc)[NACC], bool diag,
                                            int row0, int col0, int K, float* __restrict__ part) {
  __shared__ float red[kWarps][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NACC; t += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][t];
    int r, q;
    if (diag) {
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
    }
    const int i = row0 + r, j = col0 + q;
    if (i < K && j < K) part[(long long)i * K + j] = s;
  }
}

// Pass 1.  grid = (nchunks, tile pairs); work holds nchunks [K, K] partials.
// TILED = false: one diagonal tile of R = K rows.  TILED = true: R = 8 and
// blockIdx.y numbers the tile pairs (ti, tj), ti <= tj, of T = ceil(K/8)
// tiles in row-major order.
template <int R, bool TILED>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ a, long long lda, int K, long long n,
                    long long chunk, int T, float* __restrict__ work) {
  constexpr int NDIAG = R * (R + 1) / 2;
  int ti = 0, tj = 0;
  if (TILED) {
    int p = blockIdx.y;
    while (p >= T - ti) {
      p -= T - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = (c0 + chunk < n) ? c0 + chunk : n;
  const int row0 = ti * R, col0 = tj * R;
  float* part = work + (long long)blockIdx.x * K * K;

  if (!TILED || ti == tj) {
    float acc[NDIAG];
#pragma unroll
    for (int k = 0; k < NDIAG; ++k) acc[k] = 0.f;
    long long c = c0 + threadIdx.x;
    for (; c + kThreads < c1; c += 2 * kThreads) {   // two columns in flight
      float u[R], v[R];
      load_col<R>(u, a, lda, row0, K, c);
      load_col<R>(v, a, lda, row0, K, c + kThreads);
      acc_diag<R>(acc, u);
      acc_diag<R>(acc, v);
    }
    if (c < c1) {
      float u[R];
      load_col<R>(u, a, lda, row0, K, c);
      acc_diag<R>(acc, u);
    }
    block_store<R, NDIAG>(acc, true, row0, col0, K, part);
  } else if (TILED) {
    float acc[R * R];
#pragma unroll
    for (int k = 0; k < R * R; ++k) acc[k] = 0.f;
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
      float u[R], v[R];
      load_col<R>(u, a, lda, row0, K, c);
      load_col<R>(v, a, lda, col0, K, c);
      acc_full<R>(acc, u, v);
    }
    block_store<R, R * R>(acc, false, row0, col0, K, part);
  }
}

// Pass 2: G_ij = G_ji = sum over chunks, in chunk order, of partial_ij (i <= j).
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ work, int K, int nchunks, float* __restrict__ g) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= K * K) return;
  const int i = e / K, j = e % K;
  if (i > j) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += work[((long long)c * K + i) * K + j];
  g[(long long)i * K + j] = s;
  g[(long long)j * K + i] = s;
}

template <int R>
void launch_small(const float* a, long long lda, int K, long long n, long long chunk,
                  int nchunks, float* work, cudaStream_t s) {
  gram_partial_kernel<R, false><<<dim3(nchunks, 1), kThreads, 0, s>>>(a, lda, K, n, chunk, 1, work);
}

}  // namespace

extern "C" {

// g [K, K] <- A A^T for A [K, n] float32 with row stride lda (elements; the
// columns are contiguous).  work holds nchunks * K * K floats, nchunks =
// ceil(n / chunk).  K in [1, 128], n >= 1.  Returns cudaGetLastError().
int gram(const float* a, long long lda, int K, long long n, long long chunk, int nchunks,
         float* work, float* g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > 128 || n < 1 || chunk < 1 || nchunks < 1) return (int)cudaErrorInvalidValue;
  switch (K) {
#define GRAM_SMALL(k) \
  case k:             \
    launch_small<k>(a, lda, K, n, chunk, nchunks, work, s); \
    break;
    GRAM_SMALL(1) GRAM_SMALL(2) GRAM_SMALL(3) GRAM_SMALL(4)
    GRAM_SMALL(5) GRAM_SMALL(6) GRAM_SMALL(7) GRAM_SMALL(8)
    GRAM_SMALL(9) GRAM_SMALL(10) GRAM_SMALL(11) GRAM_SMALL(12)
    GRAM_SMALL(13) GRAM_SMALL(14) GRAM_SMALL(15) GRAM_SMALL(16)
#undef GRAM_SMALL
    default: {
      const int T = (K + kTiledR - 1) / kTiledR;
      gram_partial_kernel<kTiledR, true><<<dim3(nchunks, T * (T + 1) / 2), kThreads, 0, s>>>(
          a, lda, K, n, chunk, T, work);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (K * K + kThreads - 1) / kThreads;
  gram_reduce_kernel<<<blocks, kThreads, 0, s>>>(work, K, nchunks, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
