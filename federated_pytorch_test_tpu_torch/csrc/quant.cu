// The fused collective's transport codec for Hopper (sm_90a), plain C ABI:
// per-row quantize (B1) and dequantize-accumulate (B2).
//
// quantize_rows replaces the Pallas TPU kernel _quantize_kernel (launched by
// _quantize_pallas via quantize_chunks) of
// federated_pytorch_test_tpu/ops/comm_kernels.py; dequant_add replaces
// _dequant_add_kernel (launched by _dequant_add_pallas via dequant_add).
// Both run on every hop of the packed reduce-scatter of
// ops/packed_reduce.py (--compress q8|q4 --fused-collective), on a [c, cols]
// float32 row matrix: one row per codec chunk.
//
//   B1: scale[r] = max_j |v[r, j]| / qmax, safe = scale > 0 ? scale : 1,
//       q[r, j] = clip(round_half_even(v[r, j] / safe), -qmax, qmax) (int8).
//   B2: out[r, j] = acc[r, j] + q[r, j] * safe(scale[r]), two roundings.
//
// What bounds them on this card.  Both do a few operations per element, so
// they are bound by bytes.  At the path's largest shard (ResNet18's block
// [54,59] at D = 2: c = 9,220 rows of 256) B1 reads 9,441,280 B and writes
// 2,397,200 B: 3.5 us at 3.35 TB/s.  B2 reads 11,838,480 B and writes
// 9,441,280 B: 6.4 us.
//
// What the design does about it.  Every element is read from device memory
// once, with neighbouring lanes on neighbouring 16-byte vectors (coalesced):
//   * B1 takes a row a warp (a warp-stride loop over rows), keeps the row in
//     registers (up to 8 float4 a lane, rows of at most
//     1,024 floats), reduces max|v| with warp shuffles, divides once for the
//     scale, then quantizes from the registers and stores 4 int8 a lane-word.
//     Max is exact in any order, so the scale does not depend on the
//     reduction tree.  The max propagates NaN, as jnp.max and torch.amax
//     do (fmaxf would drop it).
//   * B2: a few operations an element, so what a call adds beyond the
//     bytes is host work and any extra pass: an output copied back into
//     the hop's buffer would be one more pass of 18.9 MB.  So the kernel
//     may write in place (out == acc; no __restrict__ on either, every
//     element is read and then written by the same thread), the hop
//     accumulates straight into its buffer, and the wrapper binds its
//     launch once (ops/cuda_build.py).  The matrix is walked in warp
//     blocks of 512 elements: a lane loads 16 q bytes in one 16-byte load
//     and trades them through shared memory for the q words of the four
//     float4 of acc it owns, 32 float4 apart, so every warp load and store
//     is 512 contiguous bytes.  __fmul_rn then __fadd_rn, so the compiler
//     cannot contract the two into one fused multiply-add: the result is
//     the plain version's acc + q * safe bit for bit.
// B1 rows whose width is not a multiple of 4 (or longer than 1,024), or
// whose base is not 16-byte aligned, take a scalar path with the same
// arithmetic; so does B2 (a warp a row) when cols is not a multiple of 4
// or a base is not 16-byte aligned.  Division is IEEE (no fast math):
// rintf(v / safe) is the half-to-even rounding of jnp.round and
// torch.round.  Nothing accumulates across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;     // 16 blocks of 8 warps per SM

// max that keeps a NaN: once m is NaN it stays NaN; a NaN x replaces m.
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ signed char quant1(float x, float safe, float qmax) {
  float r = rintf(__fdiv_rn(x, safe));
  r = fminf(fmaxf(r, -qmax), qmax);
  return (signed char)__float2int_rn(r);
}

__device__ __forceinline__ float safe_of(float s) { return s > 0.f ? s : 1.f; }

// B1, vector path: cols % 4 == 0, cols <= NV * 128, 16-byte aligned rows.
template <int NV>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const float* __restrict__ v, long long c, int cols, float qmax,
                    signed char* __restrict__ q, float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int nv4 = cols >> 2;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < c;
       row += nwarps) {
    const float4* src = reinterpret_cast<const float4*>(v + row * cols);
    float4 x[NV];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nv4) {
        x[j] = __ldg(src + i);
        m = nan_max(m, fabsf(x[j].x));
        m = nan_max(m, fabsf(x[j].y));
        m = nan_max(m, fabsf(x[j].z));
        m = nan_max(m, fabsf(x[j].w));
      }
    }
    m = warp_max(m);
    const float s = __fdiv_rn(m, qmax);
    const float safe = safe_of(s);
    if (lane == 0) scale[row] = s;
    char4* dst = reinterpret_cast<char4*>(q + row * cols);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nv4)
        dst[i] = make_char4(quant1(x[j].x, safe, qmax), quant1(x[j].y, safe, qmax),
                            quant1(x[j].z, safe, qmax), quant1(x[j].w, safe, qmax));
    }
  }
}

// B1, scalar path: any width; the second pass re-reads the row (from L1).
__global__ void __launch_bounds__(kThreads)
quantize_scalar_kernel(const float* __restrict__ v, long long c, int cols, float qmax,
                       signed char* __restrict__ q, float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < c;
       row += nwarps) {
    const float* src = v + row * cols;
    float m = 0.f;
    for (int i = lane; i < cols; i += 32) m = nan_max(m, fabsf(__ldg(src + i)));
    m = warp_max(m);
    const float s = __fdiv_rn(m, qmax);
    const float safe = safe_of(s);
    if (lane == 0) scale[row] = s;
    for (int i = lane; i < cols; i += 32) q[row * cols + i] = quant1(__ldg(src + i), safe, qmax);
  }
}

__device__ __forceinline__ float dq1(float a, signed char qq, float safe) {
  return __fadd_rn(a, __fmul_rn((float)qq, safe));
}

// B2, vector path (cols % 4 == 0; acc, out and q 16-byte aligned): the
// matrix as a flat run of float4, cut into warp blocks of 128 float4 (512
// elements).  Lane L loads the block's q bytes [16L, 16L + 16) in one
// 16-byte load and parks them in shared memory; it then loads the four
// float4 of acc it owns, 32 apart (each warp load is 512 contiguous bytes),
// takes their q words back from shared memory, and stores four float4.  A
// float4 lies in one row (cols % 4 == 0); its row's scale comes from the
// read-only cache.  acc and out may be one buffer (no __restrict__): every
// element is read, then written, by the same thread.
__global__ void __launch_bounds__(kThreads)
dequant_add_vec_kernel(const float* acc, const signed char* __restrict__ q,
                       const float* __restrict__ scale, long long n4, int c4, float* out) {
  __shared__ int4 qs[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nblk = (n4 + 127) >> 7;
  const long long stride = (long long)gridDim.x * kWarps;
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  float4* o4 = reinterpret_cast<float4*>(out);
  const char4* qc = reinterpret_cast<const char4*>(qs[warp]);
  for (long long b = (long long)blockIdx.x * kWarps + warp; b < nblk; b += stride) {
    const long long j0 = b << 7;               // the block's first float4
    const long long jq = j0 + 4 * lane;        // the lane's q bytes, in float4 units
    int4 v = make_int4(0, 0, 0, 0);
    if (jq + 4 <= n4) {
      v = __ldg(reinterpret_cast<const int4*>(q) + (jq >> 2));
    } else {                                   // the ragged end: 4 bytes at a time
      const int* qw = reinterpret_cast<const int*>(q);
      if (jq < n4) v.x = __ldg(qw + jq);
      if (jq + 1 < n4) v.y = __ldg(qw + jq + 1);
      if (jq + 2 < n4) v.z = __ldg(qw + jq + 2);
    }
    qs[warp][lane] = v;
    __syncwarp();
    float4 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = j0 + 32 * k + lane;
      if (j < n4) a[k] = a4[j];
    }
    long long j = j0 + lane;
    long long row = j / c4;
#pragma unroll
    for (int k = 0; k < 4; ++k, j += 32) {
      if (j < n4) {
        while (j >= (row + 1) * c4) ++row;
        const float safe = safe_of(__ldg(scale + row));
        const char4 qq = qc[32 * k + lane];
        o4[j] = make_float4(dq1(a[k].x, qq.x, safe), dq1(a[k].y, qq.y, safe),
                            dq1(a[k].z, qq.z, safe), dq1(a[k].w, qq.w, safe));
      }
    }
    __syncwarp();                              // qs is rewritten by the next block
  }
}

// B2, scalar path: a warp a row, one element a lane (any width, any
// alignment).
__global__ void __launch_bounds__(kThreads)
dequant_add_scalar_kernel(const float* acc, const signed char* __restrict__ q,
                          const float* __restrict__ scale, long long c, int cols, float* out) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < c;
       row += nwarps) {
    const float safe = safe_of(__ldg(scale + row));
    const long long base = row * cols;
    for (int i = lane; i < cols; i += 32) out[base + i] = dq1(acc[base + i], q[base + i], safe);
  }
}

int blocks_for(long long c) {
  const long long b = (c + kWarps - 1) / kWarps;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p % a) == 0; }

}  // namespace

extern "C" {

// q [c, cols] int8 and scale [c] float32 of v [c, cols] float32 (row-major,
// contiguous).  c >= 1, cols >= 1, qmax > 0.  Returns cudaGetLastError().
int quantize_rows(const float* v, long long c, int cols, float qmax, signed char* q,
                  float* scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || cols < 1 || !(qmax > 0.f)) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_for(c);
  const bool vec = cols % 4 == 0 && aligned(v, 16) && aligned(q, 4);
  const int nv = (cols / 4 + 31) / 32;
  if (vec && nv <= 1)
    quantize_vec_kernel<1><<<blocks, kThreads, 0, s>>>(v, c, cols, qmax, q, scale);
  else if (vec && nv <= 2)
    quantize_vec_kernel<2><<<blocks, kThreads, 0, s>>>(v, c, cols, qmax, q, scale);
  else if (vec && nv <= 4)
    quantize_vec_kernel<4><<<blocks, kThreads, 0, s>>>(v, c, cols, qmax, q, scale);
  else if (vec && nv <= 8)
    quantize_vec_kernel<8><<<blocks, kThreads, 0, s>>>(v, c, cols, qmax, q, scale);
  else
    quantize_scalar_kernel<<<blocks, kThreads, 0, s>>>(v, c, cols, qmax, q, scale);
  return (int)cudaGetLastError();
}

// out [c, cols] = acc + q * safe(scale) row by row; float32 acc and out,
// int8 q, float32 scale [c]; all contiguous.  out may be acc itself (in
// place) but must not overlap it otherwise.  c >= 1, cols >= 1.  Returns
// cudaGetLastError().
int dequant_add(const float* acc, const signed char* q, const float* scale, long long c,
                int cols, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  if (cols % 4 == 0 && aligned(acc, 16) && aligned(out, 16) && aligned(q, 16)) {
    const long long n4 = c * cols / 4;
    const long long b = ((n4 + 127) / 128 + kWarps - 1) / kWarps;
    const int blocks = (int)(b < kMaxBlocks ? b : kMaxBlocks);
    dequant_add_vec_kernel<<<blocks, kThreads, 0, s>>>(acc, q, scale, n4, cols / 4, out);
  } else {
    dequant_add_scalar_kernel<<<blocks_for(c), kThreads, 0, s>>>(acc, q, scale, c, cols, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
