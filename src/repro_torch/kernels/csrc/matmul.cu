// C = A @ B into a new C: the legacy suite's GEMM.
//
// Replaces the TPU kernel repro/kernels/gemm.py:matmul (_matmul_kernel).
// A (M, K) and B (K, N) are row-major with any row stride, fp32 or bf16 of
// one type; C (M, N) is fp32 or bf16 whatever the inputs are. The sums
// are fp32: each output sums its K products in ascending k, one fused
// multiply-add per product, starting from 0, and is rounded once to C's
// type. That is gemm_update.cu's order, so C equals gemm_update's
// 0 + 1 * A @ B bit for bit; no TF32 and no split-TF32: the GEMM phase's
// limit, 16 eps K rms(A) rms(B), is built to refuse them.
//
// What bounds it on an H100: operations. At M = N = K = 8192 in fp32 it
// does 2 * 8192^3 = 1.10e12 FLOP, 16.4 ms at the 67 TFLOP/s of the fp32
// pipes (the tensor cores would round the operands), against 0.8 GB of
// operands (0.24 ms at 3.35 TB/s). The FMA pipes need an FFMA issued on
// every cycle of every scheduler, so what costs is every other
// instruction and every stall: shared-memory loads, address arithmetic,
// waits on global loads, barriers.
//
// Design: a 256-thread block owns a 128 x 256 tile of C; eight warps each
// own a 64 x 64 region, each thread 8 x 16 sums (rows 4 lm.. and 32 + 4
// lm.., columns 4 ln + 16 h.., h < 4, of its warp's region, so that every
// shared read is a float4 and a warp's reads of one k touch 128 (A) and
// 64 (B, per h) contiguous bytes: no bank conflicts). Per k a thread loads
// 24 floats from shared memory for 128 FMAs, which keeps the shared-memory
// pipe below the FMA pipes (an 8 x 8 tile loads 16 for 64 and ties them).
// K is walked in 32-deep slices through a 3-stage ring in shared memory,
// filled by cp.async two slices ahead of the one being summed, so global
// loads overlap the FMAs and a block waits on memory only when the ring
// runs dry. A is stored transposed (As[k][m], 4-byte copies, neighbouring
// threads on neighbouring k in global memory), B as it lies (Bs[k][n],
// 16-byte copies where B's address and row stride are 16-byte aligned and
// the four columns lie inside N, 4-byte copies at the edges). Copies past
// M, N or K fill zeros (cp.async's source size 0), so the ragged edge needs
// no second path in the main loop. Inside a slice each thread
// double-buffers its register fragments (two float4 of A, four of B per k)
// so the next k's shared loads are in flight during this k's FMAs. 146 KB
// of shared memory and up to 255 registers a thread: one block per SM.
// bf16 inputs are widened to fp32 on their way into shared memory by
// ordinary loads and stores (cp.async copies bytes and cannot convert),
// into the same ring. The epilogue writes C with float4 stores where it
// can (fp32 C, four columns inside N, aligned), one element otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int GN = BN / 64;  // groups of 4 columns per thread, 16 apart
constexpr int PA = BM + 4;  // As row pitch: keeps float4 alignment
constexpr int STAGE_FLOATS = BK * PA + BK * BN;
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 (or 16) bytes global -> shared; a source size of 0 fills zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slice [k0, k0 + BK) of the block's rows of A and columns of B into one
// stage: As[k][m] = A[row0 + m][k0 + k], Bs[k][n] = B[k0 + k][col0 + n]
template <typename T>
__device__ __forceinline__ void load_slice(float* As, float* Bs,
                                           const T* __restrict__ A,
                                           int64_t lda,
                                           const T* __restrict__ B,
                                           int64_t ldb, int M, int N, int K,
                                           int row0, int col0, int k0,
                                           bool b_vec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < BM * BK / THREADS; ++s) {
    const int e = tid + s * THREADS;
    const int m = e / BK, k = e % BK;  // neighbours read neighbouring k
    const int gr = row0 + m, gk = k0 + k;
    const bool ok = gr < M && gk < K;
    const T* src = ok ? A + (int64_t)gr * lda + gk : A;
    if constexpr (std::is_same<T, float>::value)
      cp_async4(smem_u32(&As[k * PA + m]), src, ok);
    else
      As[k * PA + m] = ok ? to_f32(*src) : 0.f;
  }
#pragma unroll
  for (int s = 0; s < BK * BN / 4 / THREADS; ++s) {
    const int e = tid + s * THREADS;
    const int k = e / (BN / 4), n = (e % (BN / 4)) * 4;
    const int gk = k0 + k, gc = col0 + n;
    float* dst = &Bs[k * BN + n];
    const T* row = B + (int64_t)gk * ldb;
    if constexpr (std::is_same<T, float>::value) {
      if (b_vec && gk < K && gc + 3 < N) {
        cp_async16(smem_u32(dst), row + gc, true);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = gk < K && gc + j < N;
          cp_async4(smem_u32(dst + j), ok ? row + gc + j : B, ok);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = (gk < K && gc + j < N) ? to_f32(row[gc + j]) : 0.f;
    }
  }
}

__device__ __forceinline__ void load_frag(float (&a)[8], float (&b)[4 * GN],
                                          const float* As, const float* Bs,
                                          int kk, int arow, int bcol) {
  *reinterpret_cast<float4*>(&a[0]) =
      *reinterpret_cast<const float4*>(&As[kk * PA + arow]);
  *reinterpret_cast<float4*>(&a[4]) =
      *reinterpret_cast<const float4*>(&As[kk * PA + arow + 32]);
#pragma unroll
  for (int h = 0; h < GN; ++h)
    *reinterpret_cast<float4*>(&b[4 * h]) =
        *reinterpret_cast<const float4*>(&Bs[kk * BN + bcol + 16 * h]);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const T* __restrict__ A, int64_t lda, const T* __restrict__ B,
              int64_t ldb, TO* __restrict__ C, int64_t ldc, int M, int N,
              int K, int b_vec, int c_vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int arow = (warp / 4) * 64 + (lane / 4) * 4;  // rows arow.., +32..
  const int bcol = (warp % 4) * (BN / 4) + (lane % 4) * 4;  // +16 h ..
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  float acc[8][4 * GN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * GN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slice<T>(smem + s * STAGE_FLOATS, smem + s * STAGE_FLOATS + BK * PA,
                    A, lda, B, ldb, M, N, K, row0, col0, s * BK, b_vec);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();              // ... for every thread; slice kt - 1 is done
    const int next = kt + STAGES - 1;
    if (next < nk) {
      float* st = smem + (next % STAGES) * STAGE_FLOATS;
      load_slice<T>(st, st + BK * PA, A, lda, B, ldb, M, N, K, row0, col0,
                    next * BK, b_vec);
    }
    cp_async_commit();

    const float* As = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* Bs = As + BK * PA;
    float a[2][8], b[2][4 * GN];
    load_frag(a[0], b[0], As, Bs, 0, arow, bcol);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK)
        load_frag(a[(kk + 1) & 1], b[(kk + 1) & 1], As, Bs, kk + 1, arow,
                  bcol);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * GN; ++j)
          acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + arow + (i < 4 ? i : 28 + i);
    if (r >= M) continue;
    TO* crow = C + (int64_t)r * ldc;
#pragma unroll
    for (int h = 0; h < GN; ++h) {
      const int c = col0 + bcol + 16 * h;
      if constexpr (std::is_same<TO, float>::value) {
        if (c_vec && c + 3 < N) {
          *reinterpret_cast<float4*>(crow + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N) store_from_f32(crow + c + j, acc[i][4 * h + j]);
    }
  }
}

template <typename T, typename TO>
int launch(const void* a, int64_t lda, const void* b, int64_t ldb, void* c,
           int64_t ldc, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int b_vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int c_vec = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T, TO><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const T*)a, lda, (const T*)b, ldb, (TO*)c, ldc, M, N, K, b_vec, c_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C (M, N) = A (M, K) @ B (K, N); the suffix names the input type, then
// C's type.
extern "C" int repro_matmul_f32_f32(const void* a, int64_t lda, const void* b,
                                    int64_t ldb, void* c, int64_t ldc, int M,
                                    int N, int K, void* stream) {
  return launch<float, float>(a, lda, b, ldb, c, ldc, M, N, K, stream);
}

extern "C" int repro_matmul_f32_bf16(const void* a, int64_t lda,
                                     const void* b, int64_t ldb, void* c,
                                     int64_t ldc, int M, int N, int K,
                                     void* stream) {
  return launch<float, __nv_bfloat16>(a, lda, b, ldb, c, ldc, M, N, K,
                                      stream);
}

extern "C" int repro_matmul_bf16_f32(const void* a, int64_t lda,
                                     const void* b, int64_t ldb, void* c,
                                     int64_t ldc, int M, int N, int K,
                                     void* stream) {
  return launch<__nv_bfloat16, float>(a, lda, b, ldb, c, ldc, M, N, K,
                                      stream);
}

extern "C" int repro_matmul_bf16_bf16(const void* a, int64_t lda,
                                      const void* b, int64_t ldb, void* c,
                                      int64_t ldc, int M, int N, int K,
                                      void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(a, lda, b, ldb, c, ldc, M, N,
                                              K, stream);
}
