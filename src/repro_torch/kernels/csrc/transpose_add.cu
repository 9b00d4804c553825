// C = B + A^T: PTRANS's local transpose-add.
//
// Replaces the TPU kernel repro/kernels/transpose.py:transpose_add
// (_transpose_add_kernel). A is (M, N); B and C are (N, M).
//
// What bounds it on an H100: device memory. It does one addition per
// element against 3 * itemsize bytes (read A once, read B once, write C
// once): at M = N = 16384 in fp32 that is 3 GiB, 0.961 ms at 3.35 TB/s,
// against 0.268 GFLOP, nothing at the card's fp32 rate. The whole design
// is about moving those bytes in full 128-byte lines.
//
// Design: a 32x32 tile of C per 256-thread block (32 x 8 threads, four
// rows each). The block reads A's matching (32 x 32) tile with neighbouring
// threads on neighbouring columns of A (coalesced), stores it in a padded
// shared buffer ([32][33]: the column reads that follow hit 32 different
// banks), then writes C's rows with neighbouring threads on neighbouring
// columns of C, reading A^T from the buffer and B straight from device
// memory, both coalesced. Any M and N: the edge tiles are bounds-checked
// (the reference shrinks its square tile until it divides both dimensions,
// down to 1x1 on coprime shapes; this kernel does not need to). Each
// operand takes a row stride, so PTRANS's pipelined path passes column
// strips of B without a copy.
//
// Types: fp32 or bf16 (A and B of one type, C of B's type). Each element is
// one fp32 addition, rounded to nearest even, then cast once to C's type:
// the same bits as (b.float() + a.float().T).to(b.dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // thread rows per block; each covers TILE / ROWS

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
transpose_add_kernel(const T* __restrict__ A, int64_t lda,
                     const T* __restrict__ B, int64_t ldb,
                     T* __restrict__ C, int64_t ldc, int M, int N) {
  __shared__ float tile[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * TILE;  // rows of C = columns of A
  const int j0 = blockIdx.x * TILE;  // columns of C = rows of A
  // A's rows j0.., columns i0..: tile[r][c] = A[j0 + r][i0 + c]
#pragma unroll
  for (int r = ty; r < TILE; r += ROWS) {
    const int ar = j0 + r, ac = i0 + tx;
    if (ar < M && ac < N) tile[r][tx] = to_f32(A[(int64_t)ar * lda + ac]);
  }
  __syncthreads();
  // C[i0 + r][j0 + c] = B[i0 + r][j0 + c] + A[j0 + c][i0 + r]
#pragma unroll
  for (int r = ty; r < TILE; r += ROWS) {
    const int ci = i0 + r, cj = j0 + tx;
    if (ci < N && cj < M) {
      const float b = to_f32(B[(int64_t)ci * ldb + cj]);
      store_from_f32(C + (int64_t)ci * ldc + cj, __fadd_rn(b, tile[tx][r]));
    }
  }
}

template <typename T>
int launch(const void* a, int64_t lda, const void* b, int64_t ldb, void* c,
           int64_t ldc, int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE);
  const dim3 block(TILE, ROWS);
  transpose_add_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)a, lda, (const T*)b, ldb, (T*)c, ldc, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_transpose_add_f32(const void* a, int64_t lda,
                                       const void* b, int64_t ldb, void* c,
                                       int64_t ldc, int M, int N,
                                       void* stream) {
  return launch<float>(a, lda, b, ldb, c, ldc, M, N, stream);
}

extern "C" int repro_transpose_add_bf16(const void* a, int64_t lda,
                                        const void* b, int64_t ldb, void* c,
                                        int64_t ldc, int M, int N,
                                        void* stream) {
  return launch<__nv_bfloat16>(a, lda, b, ldb, c, ldc, M, N, stream);
}
