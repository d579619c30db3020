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
// P = 9: the forward must read 2*D*P*4 B = 295 KB and do ~2*D*P^2 = 0.66 MFLOP,
// the backward read and write twice that.  Both are far below a microsecond
// at 3.35 TB/s, so the kernels are bound by launch latency and by the serial
// depth of the reduction over D, not by bytes or FLOPs; with P = 9 there are
// only 9 score rows to hand to 132 SMs.
//
// What the design does about it.  One block per score row (P blocks of 512
// threads).  Inside a block the threads form a [nslot x TJ] grid: TJ =
// min(P, 512) score columns by nslot = 512/TJ slots of rows of D (at P = 9:
// 9 columns by 56 slots), so the serial walk over D is D/nslot = 73 rows
// long instead of D, and at small P the block reads Zhat as whole
// consecutive runs.  The slot partials are summed per column in a fixed
// order through shared memory.  The P-long score row never leaves shared
// memory.  No padding: columns j >= P are simply not computed, which is the
// Pallas kernel's masking of its pad columns.
//
// The Pallas backward sums dZhat across its grid steps, which works on a TPU
// because the grid runs in order.  A CUDA grid runs in no order, so the
// backward is two kernels with no atomics, and gives the same bits run to
// run: pass 1 (one block per score row) writes Gn, its transpose, G*zz and
// the row term into a [3P^2 + 2P] scratch; pass 2 (one thread per output
// element) forms dZ and dZhat, summing the column term over i in a fixed
// order.  No fast math: expf, logf, sqrtf and division stay IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;            // threads of a score-row block
constexpr int kWarps = kThreads / 32;    // warps of a score-row block
constexpr int kGradThreads = 256;        // threads of a pass-2 block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

__device__ __forceinline__ float safe_norm(float sq) {
  return sqrtf(sq == 0.f ? 1.f : sq);
}

// Score row i: srow[j] = zz_ij for j < P (shared memory), zhn[j] = |zhat_j|
// when zhn is not null.  Returns |z_i|.  `red` holds 2*kThreads floats.
//
// The block's threads form a [nslot x TJ] grid over (rows of D, columns j):
// TJ = min(P, kThreads) columns per tile, nslot = kThreads / TJ slots, each
// walking every nslot-th row.  For small P the block then reads whole
// consecutive runs of Zhat (thread t reads element t of each nslot*P chunk)
// and each thread walks only D/nslot rows; the slot partials are summed per
// column in a fixed order.
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
infonce_fwd_kernel(const float* __restrict__ Z, const float* __restrict__ Zh,
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

extern "C" {

// log_p[P] <- Z, Zh [D, P] row-major float32.  Returns cudaGetLastError().
int infonce_fwd(const float* Z, const float* Zh, float* log_p, long long D, int P,
                void* stream) {
  const size_t smem = (size_t)P * sizeof(float);
  infonce_fwd_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(Z, Zh, log_p, D, P);
  return (int)cudaGetLastError();
}

// dZ, dZh [D, P] <- Z, Zh [D, P], log_p, ghat [P].  scratch holds 3*P*P + 2*P
// floats.  Returns cudaGetLastError().
int infonce_bwd(const float* Z, const float* Zh, const float* log_p, const float* ghat,
                float* dZ, float* dZh, float* scratch, long long D, int P,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
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

}  // extern "C"
