// C <- C + alpha * A @ B, in place on C: HPL's trailing rank-b update.
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm_update
// (_gemm_update_kernel). What bounds it on an H100: at HPL's shapes
// (M = N = 16384, K = b = 64, fp32) the call does 2*M*N*K = 34.4 GFLOP and
// must move C in and out once, 2*4*M*N = 2.15 GB: about 0.51 ms of fp32
// FMAs (67 TFLOP/s outside the tensor cores) against 0.64 ms of HBM traffic
// (3.35 TB/s), so device memory bounds it, with the FMA rate close behind.
// Tensor cores are ruled out for fp32 inputs: TF32 would round the operands
// and the HPL residual and parity gates assume IEEE fp32 products.
//
// Design: a tiled SIMT GEMM. A 256-thread block owns a 128x128 tile of C;
// A and B stream through shared memory in 16-deep slices (A stored
// transposed so that both operands are read as float4), and each thread
// keeps an 8x8 register micro-tile of fp32 sums. C is read once and written
// once, in the epilogue, as C + alpha * sum (alpha * sum added to C in one
// fused multiply-add). Row strides (lda, ldb, ldc) let the caller pass
// column strips of a larger matrix without a copy.
//
// Each output element sums its K products in ascending k, one fused
// multiply-add per product, starting from 0; out-of-range k are padded with
// zeros on both operands. That sequence depends on neither M, N nor the
// tile position, so an update of a row or column strip gives the same bits
// as the full update restricted to that strip (HPL lookahead relies on it).
//
// Inputs are fp32 or bf16 (A, B and C of one type); the sums are fp32 and
// the bf16 result is rounded to nearest even. The legacy GEMM's C = A @ B
// has its own pipelined main loop in matmul.cu, with the same order of
// sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int PITCH = BM + 4;  // keeps float4 alignment, spreads banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
// {tx*4 + j, 64 + tx*4 + j}, i, j < 4: a quarter-warp then reads 128
// contiguous bytes of shared memory, and the epilogue writes 16-byte runs.
__device__ __forceinline__ int sub(int base, int q) {
  return (q < 4) ? base * 4 + q : 64 + base * 4 + (q - 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, int64_t lda, const T* __restrict__ B,
            int64_t ldb, T* C, int64_t ldc, int M, int N, int K,
            float alpha) {
  __shared__ __align__(16) float As[BK][PITCH];  // As[k][m] = A[m][k]
  __shared__ __align__(16) float Bs[BK][PITCH];  // Bs[k][n] = B[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int m = e / BK, k = e % BK;  // neighbours read neighbouring k
      const int gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? to_f32(A[(int64_t)gr * lda + gk]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int k = e / BN, n = e % BN;  // neighbours read neighbouring n
      const int gk = k0 + k, gc = col0 + n;
      Bs[k][n] = (gk < K && gc < N) ? to_f32(B[(int64_t)gk * ldb + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + sub(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + sub(tx, j);
      if (c >= N) continue;
      T* p = C + (int64_t)r * ldc + c;
      store_from_f32(p, fmaf(alpha, acc[i][j], to_f32(*p)));
    }
  }
}

template <typename T>
int launch(const void* a, int64_t lda, const void* b, int64_t ldb, void* c,
           int64_t ldc, int M, int N, int K, float alpha, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, lda, (const T*)b, ldb, (T*)c, ldc, M, N, K, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_gemm_update_f32(const void* a, int64_t lda,
                                     const void* b, int64_t ldb, void* c,
                                     int64_t ldc, int M, int N, int K,
                                     float alpha, void* stream) {
  return launch<float>(a, lda, b, ldb, c, ldc, M, N, K, alpha, stream);
}

extern "C" int repro_gemm_update_bf16(const void* a, int64_t lda,
                                      const void* b, int64_t ldb, void* c,
                                      int64_t ldc, int M, int N, int K,
                                      float alpha, void* stream) {
  return launch<__nv_bfloat16>(a, lda, b, ldb, c, ldc, M, N, K, alpha,
                               stream);
}
