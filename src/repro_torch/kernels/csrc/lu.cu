// HPL's diagonal-block LU and its two panel solves, in fp32.
//
// Replace the TPU kernels repro/kernels/lu.py:lu_factor_block
// (_lu_block_kernel), :trsm_lower_left (_trsm_lower_kernel) and
// :trsm_upper_right (_trsm_upper_kernel).
//
// What bounds them on an H100: latency, not bytes or FLOPs. At HPL's b = 64
// the LU touches 16 KiB and does 2/3 b^3 = 0.17 MFLOP in b dependent steps;
// each panel solve reads a (64 x 16384) panel (4 MiB) and does b^2 = 4096
// FLOP per column, but as a chain of b dependent steps per column. The
// design keeps every operand of those chains in shared memory, so each
// step costs a few shared-memory accesses, and puts one independent column
// (or row) on each thread.
//
// - lu_factor_block: one CTA holds the (n, n) block in shared memory
//   (16 KiB at n = 64, 64 KiB at n = 128, the most it takes) and runs the
//   unpivoted Doolittle steps with a barrier between the pivot-column
//   scaling and the rank-1 update of each step.
// - trsm_lower_left: X = L^{-1} B. A grid over column slabs of B; each CTA
//   loads the packed LU and its slab into shared memory, and each thread
//   runs forward substitution down one column.
// - trsm_upper_right: X = B U^{-1}. A grid over row slabs of B, loaded
//   coalesced and stored transposed in shared memory; each thread solves
//   one row, column by column, dividing by U[j, j].
//
// Every sum runs in ascending index order, one fused multiply-add per term.
// Divisions are IEEE (the build does not use fast math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LU_THREADS = 256;  // 8 warps; a warp covers 32 columns

__global__ void __launch_bounds__(LU_THREADS)
lu_factor_block_kernel(const float* __restrict__ A, int64_t lda,
                       float* __restrict__ out, int n) {
  extern __shared__ float s[];  // s[i * n + j] = block[i][j]
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;
  for (int e = tid; e < n * n; e += LU_THREADS)
    s[e] = A[(int64_t)(e / n) * lda + e % n];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float pivot = s[k * n + k];
    for (int i = k + 1 + tid; i < n; i += LU_THREADS)
      s[i * n + k] = s[i * n + k] / pivot;
    __syncthreads();
    for (int i = k + 1 + ty; i < n; i += LU_THREADS / 32) {
      const float l = s[i * n + k];
      for (int j = k + 1 + tx; j < n; j += 32)
        s[i * n + j] = fmaf(-l, s[k * n + j], s[i * n + j]);
    }
    __syncthreads();
  }
  for (int e = tid; e < n * n; e += LU_THREADS) out[e] = s[e];
}

__global__ void trsm_lower_left_kernel(const float* __restrict__ LU,
                                       int64_t ldl,
                                       const float* __restrict__ B,
                                       int64_t ldb, float* __restrict__ X,
                                       int n, int N) {
  extern __shared__ float sm[];
  float* L = sm;           // n x n packed LU
  float* Xs = sm + n * n;  // Xs[i * slab + t] = column t of this slab
  const int slab = blockDim.x;
  const int t = threadIdx.x;
  const int j = blockIdx.x * slab + t;
  for (int e = t; e < n * n; e += slab) L[e] = LU[(int64_t)(e / n) * ldl + e % n];
  for (int i = 0; i < n; ++i)
    Xs[i * slab + t] = (j < N) ? B[(int64_t)i * ldb + j] : 0.f;
  __syncthreads();
  for (int i = 1; i < n; ++i) {
    float acc = Xs[i * slab + t];
    for (int k = 0; k < i; ++k) acc = fmaf(-L[i * n + k], Xs[k * slab + t], acc);
    Xs[i * slab + t] = acc;
  }
  if (j < N)
    for (int i = 0; i < n; ++i) X[(int64_t)i * N + j] = Xs[i * slab + t];
}

__global__ void trsm_upper_right_kernel(const float* __restrict__ LU,
                                        int64_t ldl,
                                        const float* __restrict__ B,
                                        int64_t ldb, float* __restrict__ X,
                                        int n, int M) {
  extern __shared__ float sm[];
  float* U = sm;           // n x n packed LU
  float* Xs = sm + n * n;  // Xs[j * pitch + r] = row r of this slab, col j
  const int slab = blockDim.x, pitch = slab + 1;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * slab;
  for (int e = t; e < n * n; e += slab) U[e] = LU[(int64_t)(e / n) * ldl + e % n];
  for (int e = t; e < slab * n; e += slab) {
    const int r = e / n, c = e % n;  // neighbours read neighbouring columns
    Xs[c * pitch + r] = (r0 + r < M) ? B[(int64_t)(r0 + r) * ldb + c] : 0.f;
  }
  __syncthreads();
  for (int c = 0; c < n; ++c) {
    float acc = Xs[c * pitch + t];
    for (int k = 0; k < c; ++k) acc = fmaf(-Xs[k * pitch + t], U[k * n + c], acc);
    Xs[c * pitch + t] = acc / U[c * n + c];
  }
  __syncthreads();
  for (int e = t; e < slab * n; e += slab) {
    const int r = e / n, c = e % n;
    if (r0 + r < M) X[(int64_t)(r0 + r) * n + c] = Xs[c * pitch + r];
  }
}

// Opts a kernel into more than the default 48 KiB of dynamic shared memory.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// out (n x n, contiguous) = packed L\U of the (n x n) block at a (row stride
// lda).
extern "C" int repro_lu_factor_block_f32(const void* a, int64_t lda, void* out,
                                         int n, void* stream) {
  const size_t smem = (size_t)n * n * sizeof(float);
  cudaError_t err = allow_smem(lu_factor_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lu_factor_block_kernel<<<1, LU_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)a, lda, (float*)out, n);
  return (int)cudaGetLastError();
}

// x (n x N, contiguous) = L^{-1} b for the (n x N) panel b (row stride ldb);
// slab columns per CTA, N % slab == 0.
extern "C" int repro_trsm_lower_left_f32(const void* lu, int64_t ldl,
                                         const void* b, int64_t ldb, void* x,
                                         int n, int N, int slab, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = (size_t)n * (n + slab) * sizeof(float);
  cudaError_t err = allow_smem(trsm_lower_left_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_lower_left_kernel<<<N / slab, slab, smem, (cudaStream_t)stream>>>(
      (const float*)lu, ldl, (const float*)b, ldb, (float*)x, n, N);
  return (int)cudaGetLastError();
}

// x (M x n, contiguous) = b U^{-1} for the (M x n) panel b (row stride ldb);
// slab rows per CTA, M % slab == 0.
extern "C" int repro_trsm_upper_right_f32(const void* lu, int64_t ldl,
                                          const void* b, int64_t ldb, void* x,
                                          int n, int M, int slab,
                                          void* stream) {
  if (M <= 0) return 0;
  const size_t smem = ((size_t)n * n + (size_t)n * (slab + 1)) * sizeof(float);
  cudaError_t err = allow_smem(trsm_upper_right_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_upper_right_kernel<<<M / slab, slab, smem, (cudaStream_t)stream>>>(
      (const float*)lu, ldl, (const float*)b, ldb, (float*)x, n, M);
  return (int)cudaGetLastError();
}
