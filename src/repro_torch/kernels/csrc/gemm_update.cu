// C <- C + alpha * A @ B, in place on C: HPL's trailing rank-b update.
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm_update
// (_gemm_update_kernel). Two kernels, one per input type (A, B and C of
// one type); the wrapper (kernels/gemm.py) picks by dtype alone: route
// ``simt_f32`` for fp32, ``wgmma_bf16`` for bf16.
//
// fp32 (gemm_update_kernel, HPL's path). What bounds it on an H100: at
// HPL's shapes (M = N = 16384, K = b = 64) the call must move C in and out
// once, 2 * 4 * M * N = 2.15 GB, 0.64 ms at 3.35 TB/s: device memory
// bounds it. Its 2 * M * N * K = 34.4 GFLOP take 0.51 ms at the 67 TFLOP/s
// of the fp32 pipes (outside the tensor cores), so the FMA bound is close
// behind, and neither can hide the other unless C streams while the FMAs
// run. Tensor cores are ruled out for fp32 inputs: TF32 (or a split of it)
// would round the operands, and the HPL residual and parity gates assume
// IEEE fp32 products.
//
// Design: one CTA of 4 warps per tile of C, two CTAs to an SM. Tiles are
// 128 x 128 (8 x 16 sums a thread), or 64 x 128 and 128 x 64 (8 x 8) for
// HPL's 64-row and 64-column lookahead strips and for a C of fewer 128 x
// 128 tiles than SMs: the host picks the shape and sizes the grid
// (kernels/gemm.py:gemm_geometry). Against the bytes:
//   - C streams while the FMAs run. Right after the first slice of A and B
//     a CTA asks TMA (the tensor memory accelerator) for its whole C tile,
//     one tensor copy into shared memory completing on an mbarrier, so C's
//     HBM read overlaps the FMAs. The epilogue reads C from shared memory,
//     writes C + alpha * sum back in place, and one TMA tensor store writes
//     the tile out; the CTA leaves once TMA has read it. The SM's other
//     CTA, in its FMAs meanwhile, hides both ends.
//   - A and B (4 MB each at HPL's shape, resident in the 50 MB L2) reach
//     shared memory by TMA too, one box each per 16-deep K slice through a
//     2-stage ring (thread 0 issues them; the next slice is in flight while
//     one is summed). Threads issue no copies of their own on this path:
//     while TMA streamed C, every cp.async a thread issued cost it
//     hundreds of cycles (PERF.md). A lands as float4 runs of four k,
//     As[k / 4][m][k % 4] (a three-dimensional box), B as it lies.
// Against the operations: each warp owns 32 rows and 32 GN columns, each
// thread 8 rows and 4 GN columns, fed by float4 shared reads (A four k at
// a time, B one k ahead in a double buffer). At 8 x 16, a thread loads 24
// floats from shared memory for 128 FMAs, which keeps the shared-memory
// pipe below the FMA pipe; the 8 lanes of a quarter warp share their rows
// and cover 32 contiguous columns, so no access to A, B or C in shared
// memory meets a bank conflict.
// Where TMA cannot address an operand (its address, its row stride or its
// width in bytes not a multiple of 16; TMA's stores write the whole
// 16-byte run at a ragged right edge, past the matrix) the threads move
// it: A and B by cp.async (4-byte copies at unaligned or ragged places),
// and C read and written in global memory by the epilogue, one element at
// a time. Rows past M and columns past N are never written. Row strides
// (lda, ldb, ldc) let the caller pass strips of a larger matrix without a
// copy.
//
// Each output element sums its K products in ascending k, one fused
// multiply-add per product, starting from +0; k past K, up to the next
// multiple of 16, adds a product of two +0 (as the first port's kernel
// did). The epilogue is fmaf(alpha, sum, c). That sequence depends on
// neither M, N, the tile shape nor the tile's position, so an update of a
// row or column strip gives the same bits as the full update restricted
// to that strip (HPL lookahead relies on it), and the output bits equal
// the first port's kernel's (chip_smoke.py GEMM_BITS). The legacy GEMM's
// C = A @ B has its own main loop in matmul.cu, with the same order of
// sums. This kernel takes fp32 only; bf16 has a kernel of its own below.
//
// bf16 (gemm_update_bf16_kernel): C <- bf16_rn(fmaf(alpha, sum, c)), the
// sums fp32 over the exact fp32 products of the bf16 operands, on the
// tensor cores (wgmma), as the TPU kernel runs its bf16 product on its
// matrix unit with fp32 sums. What bounds it: bytes. At HPL's shape C
// moves in and out once, 2 * 2 * M * N = 1.07 GB, 0.322 ms at 3.35
// TB/s; its 34.4 GFLOP take 0.035 ms at the 989 TFLOP/s of the bf16
// tensor cores (on the fp32 pipes they alone would take 0.51 ms, above
// the byte bound). So it is a streaming kernel whose only job is to keep
// C's reads and writes in flight:
//   - persistent CTAs, one per SM (the shared memory allows no second),
//     each walking the 128 x 128 tiles of C w = blockIdx.x, + gridDim.x,
//     ... (row-major, so the CTAs in flight share A's rows);
//   - warpgroup 0 is the producer: one thread keeps TMA loads in flight,
//     each tile's C (four 64 x 64 boxes) into a 3-stage ring, and its A
//     (128 x 64) and B (64 x 128) slices of 64 k into a 3-stage ring, all
//     128-byte swizzled;
//   - warpgroups 1 and 2 each own 64 rows of a tile: per 64-deep K slice,
//     4 wgmma m64n128k16 with A K-major and B MN-major in shared memory
//     (the transpose bit: B is N-contiguous), fp32 accumulators in
//     registers; then the epilogue reads C from its shared stage (the
//     swizzle spreads a warp's 8 rows over all banks), writes
//     bf16_rn(fmaf(alpha, sum, c)) back in place, and the warpgroup's
//     thread 0 sends its 64 rows out by TMA store. The stage is handed
//     back to the producer once the next tile's store is issued and this
//     one's has been read, so a tile's epilogue and store overlap the
//     next tiles' loads.
// Each output sums its K products in the tensor core's order within each
// 16-deep step and in ascending 16-deep steps, from +0, whatever the
// tile, its position or the shape of C (the instruction is always m64n128k16
// on the same slices of K), so a row or column strip updated alone gives
// the bits of the full update restricted to it; chip_smoke.py holds that,
// and two runs bit-identical, on the card. The bits differ from the fp32
// route's one FMA per k by design. TMA alone moves every operand, so the
// wrapper refuses what it cannot address (address, row stride or width in
// bytes not a multiple of 16) before any launch. Ragged M, N and K are
// zero-filled by TMA past the edge; boxes wholly past M or N are neither
// loaded nor stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BK = 16;
constexpr int STAGES = 2;

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a TMA box of ``map`` at coordinates (x, y) or (x, y, z) into shared
// memory at ``dst``, completing on the mbarrier ``bar``; elements past the
// tensor's edge read as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}
// shared memory at ``src`` into the box at (col, row) of ``map`` (TMA),
// without committing; elements past C's edge are not written
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N committed store groups may still read their shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel
// ---------------------------------------------------------------------------

// The tile shapes: WM x WN warps, each owning 32 rows and 32 GN columns;
// each thread 8 rows and 4 GN columns of them.
template <int WM, int WN, int GN>
struct Shape {
  static constexpr int BM = 32 * WM, BN = 32 * GN * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int A_FLOATS = BM * BK, STAGE_FLOATS = A_FLOATS + BK * BN;
  static constexpr int C_BYTES = 4 * BM * BN;  // TMA's box
  static constexpr int RING_BYTES = 4 * STAGES * STAGE_FLOATS;
  // + the mbarriers: C's, then one a stage
  static constexpr int SMEM = C_BYTES + RING_BYTES + 8 * (1 + STAGES);
};

// One slice [k0, k0 + BK) of the tile's rows of A and columns of B into a
// stage, by the threads, where TMA does not bring it: A as float4 runs of
// four k, As[k / 4][m][k % 4] = A[row0 + m][k0 + k] (the layout TMA's
// three-dimensional box gives), B as it lies, Bs[k][n] = B[k0 + k][col0 +
// n]; 16-byte copies where the operand's address and row stride allow and
// the four elements lie inside it, 4-byte copies at the edges.
template <typename S>
__device__ __forceinline__ void load_slice(float* As, float* Bs,
                                           const float* __restrict__ A,
                                           int64_t lda,
                                           const float* __restrict__ B,
                                           int64_t ldb, int M, int N, int K,
                                           int row0, int col0, int k0,
                                           bool a_vec, bool b_vec,
                                           bool with_a, bool with_b) {
  const int tid = threadIdx.x;
  if (with_a) {
#pragma unroll
    for (int s = 0; s < S::BM * BK / 4 / S::THREADS; ++s) {
      const int e = tid + s * S::THREADS;
      const int m = e / (BK / 4), k = e % (BK / 4) * 4;  // rows' k runs
      const int gr = row0 + m, gk = k0 + k;
      float* dst = &As[(k / 4 * S::BM + m) * 4];
      const float* src = A + (int64_t)gr * lda + gk;
      if (a_vec && gr < M && gk + 3 < K) {
        cp_async16(smem_u32(dst), src, true);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = gr < M && gk + j < K;
          cp_async4(smem_u32(dst + j), ok ? src + j : A, ok);
        }
      }
    }
  }
  if (!with_b) return;
#pragma unroll
  for (int s = 0; s < BK * S::BN / 4 / S::THREADS; ++s) {
    const int e = tid + s * S::THREADS;
    const int k = e / (S::BN / 4), n = (e % (S::BN / 4)) * 4;
    const int gk = k0 + k, gc = col0 + n;
    float* dst = &Bs[k * S::BN + n];
    const float* row = B + (int64_t)gk * ldb;
    if (b_vec && gk < K && gc + 3 < N) {
      cp_async16(smem_u32(dst), row + gc, true);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gk < K && gc + j < N;
        cp_async4(smem_u32(dst + j), ok ? row + gc + j : B, ok);
      }
    }
  }
}

// a thread's rows: arow + i for i < 4, arow + 12 + i (16 further on) after
__device__ __forceinline__ int row_of(int arow, int i) {
  return arow + (i < 4 ? i : 12 + i);
}

// A at the thread's 8 rows and k .. k + 3 (k a multiple of 4): one float4
// a row, the same for the 8 lanes of a quarter warp
template <int BM>
__device__ __forceinline__ void load_a(float (&a)[8][4], const float* As,
                                       int k, int arow) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(
        &As[(k / 4 * BM + row_of(arow, i)) * 4]);
}

// B at k and the thread's columns: bcol + 32 h .. + 3, h < GN; a quarter
// warp reads 128 contiguous bytes
template <int BN, int GN>
__device__ __forceinline__ void load_b(float (&b)[4 * GN], const float* Bs,
                                       int k, int bcol) {
#pragma unroll
  for (int h = 0; h < GN; ++h)
    *reinterpret_cast<float4*>(&b[4 * h]) =
        *reinterpret_cast<const float4*>(&Bs[k * BN + bcol + 32 * h]);
}

// The maps TMA moves the tile with; a ``*_tma`` flag of 0 says the map is
// unused and the threads move that operand.
struct Maps {
  CUtensorMap a, b, c;
};

template <int WM, int WN, int GN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
gemm_update_kernel(const float* __restrict__ A, int64_t lda,
                   const float* __restrict__ B, int64_t ldb, float* C,
                   int64_t ldc, const __grid_constant__ Maps maps, int a_tma,
                   int b_tma, int c_tma, int M, int N, int K, float alpha,
                   int a_vec, int b_vec) {
  using S = Shape<WM, WN, GN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + S::C_BYTES);
  const uint32_t bar_c = smem_u32(smem + S::C_BYTES + S::RING_BYTES);
  const uint32_t bar_ab = bar_c + 8;  // one a stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the 8 lanes of a quarter warp share rows and cover 32 contiguous
  // columns, so no shared-memory access of theirs meets a bank conflict
  const int arow = (warp / WN) * 32 + (lane / 8) * 4;  // rows arow.., +16..
  const int bcol = (warp % WN) * 32 * GN + (lane % 8) * 4;  // +32 h ..
  const int tiles_n = (N + S::BN - 1) / S::BN;
  const int row0 = (int)blockIdx.x / tiles_n * S::BM;
  const int col0 = (int)blockIdx.x % tiles_n * S::BN;
  const int nks = max((K + BK - 1) / BK, 1);  // K = 0: one slice of zeros
  // slice ks into its stage: A and B each by one TMA box (thread 0) where
  // TMA can address them, else by every thread's copies
  auto issue_slice = [&](int ks) {
    float* As = ring + (ks % STAGES) * S::STAGE_FLOATS;
    float* Bs = As + S::A_FLOATS;
    load_slice<S>(As, Bs, A, lda, B, ldb, M, N, K, row0, col0, ks * BK,
                  a_vec, b_vec, !a_tma, !b_tma);
    if ((a_tma || b_tma) && tid == 0) {
      const uint32_t bar = bar_ab + 8 * (ks % STAGES);
      mbar_expect_tx(bar, 4 * (a_tma * S::A_FLOATS + b_tma * BK * S::BN));
      if (a_tma) tma_load(smem_u32(As), &maps.a, bar, 0, row0, ks * BK / 4);
      if (b_tma) tma_load(smem_u32(Bs), &maps.b, bar, col0, ks * BK);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bar_c + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue_slice(0);
  cp_async_commit();
  // then C's tile into Cs by one TMA copy, where TMA can address C; else
  // the epilogue reads and writes C in global memory
  if (c_tma && tid == 0) {
    mbar_expect_tx(bar_c, S::C_BYTES);
    tma_load(smem_u32(Cs), &maps.c, bar_c, col0, row0);
  }

  float acc[8][4 * GN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * GN; ++j) acc[i][j] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    cp_async_wait_all();  // the threads' copies of slice ks have landed
    __syncthreads();      // ... for every thread; slice ks - 1 is done
    if (a_tma || b_tma)   // TMA's too
      mbar_wait(bar_ab + 8 * (ks % STAGES), (ks / STAGES) & 1);
    if (ks + 1 < nks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_slice(ks + 1);
    }
    cp_async_commit();

    const float* As = ring + (ks % STAGES) * S::STAGE_FLOATS;
    const float* Bs = As + S::A_FLOATS;
    // A four k at a time, B one k ahead
    float a[8][4], b[2][4 * GN];
    load_a<S::BM>(a, As, 0, arow);
    load_b<S::BN, GN>(b[0], Bs, 0, bcol);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK) load_b<S::BN, GN>(b[(kk + 1) & 1], Bs, kk + 1, bcol);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * GN; ++j)
          acc[i][j] = fmaf(a[i][kk & 3], b[kk & 1][j], acc[i][j]);
      if ((kk & 3) == 3 && kk + 1 < BK) load_a<S::BM>(a, As, kk + 1, arow);
    }
  }

  // the epilogue: C + alpha * sum, in Cs and out by TMA, or in global
  // memory
  if (c_tma) {
    mbar_wait(bar_c, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* crow = Cs + row_of(arow, i) * S::BN + bcol;
#pragma unroll
      for (int h = 0; h < GN; ++h) {
        float4* p = reinterpret_cast<float4*>(crow + 32 * h);
        const float4 cv = *p;
        *p = make_float4(fmaf(alpha, acc[i][4 * h], cv.x),
                         fmaf(alpha, acc[i][4 * h + 1], cv.y),
                         fmaf(alpha, acc[i][4 * h + 2], cv.z),
                         fmaf(alpha, acc[i][4 * h + 3], cv.w));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the tile is in Cs
    if (tid == 0) {
      tma_store_box(&maps.c, smem_u32(Cs), col0, row0);
      tma_store_commit();
      tma_store_wait_read<0>();  // Cs stays until TMA has read it
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + row_of(arow, i);
    if (r >= M) continue;
    float* crow = C + (int64_t)r * ldc;
#pragma unroll
    for (int h = 0; h < GN; ++h) {
      const int c = col0 + bcol + 32 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N)
          crow[c + j] = fmaf(alpha, acc[i][4 * h + j], crow[c + j]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA's map of a rows x cols matrix of ``esize``-byte elements (row stride
// ld) in boxes of box_rows x box_cols, or false where TMA cannot address
// it: its address, its row stride or its width in bytes not a multiple of
// 16 (at a ragged right edge TMA moves the whole 16-byte run, past the
// matrix). With ``quads``, the map is three-dimensional, (k % 4, row, k /
// 4), so that a box lands as float4 runs of four columns, row after row
// (the fp32 kernel's A).
bool make_map(CUtensorMap* map, const void* ptr, int64_t ld, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapDataType type,
              int esize, CUtensorMapSwizzle swizzle, bool quads = false) {
  EncodeTiled enc = encode_tiled();
  if (!enc || rows <= 0 || cols <= 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 || (ld * esize) % 16 ||
      ((int64_t)cols * esize) % 16)
    return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  if (quads) {
    const cuuint64_t dims[3] = {4, (cuuint64_t)rows, (cuuint64_t)cols / 4};
    const cuuint64_t strides[2] = {(cuuint64_t)(ld * esize),
                                   (cuuint64_t)(4 * esize)};
    const cuuint32_t box[3] = {4, (cuuint32_t)box_rows,
                               (cuuint32_t)box_cols / 4};
    return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool make_map_f32(CUtensorMap* map, const void* ptr, int64_t ld, int rows,
                  int cols, int box_rows, int box_cols, bool quads = false) {
  return make_map(map, ptr, ld, rows, cols, box_rows, box_cols,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  CU_TENSOR_MAP_SWIZZLE_NONE, quads);
}

template <int WM, int WN, int GN>
int launch_shape(const void* a, int64_t lda, const void* b, int64_t ldb,
                 void* c, int64_t ldc, int M, int N, int K, float alpha,
                 int64_t ctas, void* stream) {
  using S = Shape<WM, WN, GN>;
  if (ctas != (int64_t)((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN))
    return (int)cudaErrorInvalidValue;  // one CTA per tile
  auto kernel = gemm_update_kernel<WM, WN, GN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int a_vec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int b_vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // TMA moves A, B and C where it can address them
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int a_tma = make_map_f32(&maps.a, a, lda, M, K, S::BM, BK, true);
  const int b_tma = make_map_f32(&maps.b, b, ldb, K, N, BK, S::BN);
  const int c_tma = make_map_f32(&maps.c, c, ldc, M, N, S::BM, S::BN);
  kernel<<<(unsigned)ctas, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
      (const float*)a, lda, (const float*)b, ldb, (float*)c, ldc, maps, a_tma,
      b_tma, c_tma, M, N, K, alpha, a_vec, b_vec);
  return (int)cudaGetLastError();
}

// tile: 0 = 128 x 128 (8 x 16 sums a thread), 1 = 64 x 128 and 2 = 128 x
// 64 (8 x 8), as kernels/gemm.py:TILES lists them
int launch(const void* a, int64_t lda, const void* b, int64_t ldb, void* c,
           int64_t ldc, int M, int N, int K, float alpha, int tile,
           int64_t ctas, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  switch (tile) {
    case 0:
      return launch_shape<4, 1, 4>(a, lda, b, ldb, c, ldc, M, N, K, alpha,
                                   ctas, stream);
    case 1:
      return launch_shape<2, 2, 2>(a, lda, b, ldb, c, ldc, M, N, K, alpha,
                                   ctas, stream);
    case 2:
      return launch_shape<4, 1, 2>(a, lda, b, ldb, c, ldc, M, N, K, alpha,
                                   ctas, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;          // rows of a C tile: two consumer warpgroups
constexpr int BN = 128;          // columns of a C tile
constexpr int KS = 64;           // K slice: one 128-byte swizzled bf16 row
constexpr int BOX = 64;          // bf16 columns of a TMA box (128 bytes)
constexpr int C_STAGES = 3;      // C tiles in flight
constexpr int AB_STAGES = 3;     // A and B slices in flight
constexpr int THREADS = 384;     // producer warpgroup, then two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int ROWB = 128;        // bytes of a swizzled row
constexpr int C_BYTES = BM * BN * 2;   // two column blocks of BM x 64
constexpr int A_BYTES = BM * KS * 2;   // one box of BM x 64
constexpr int B_BYTES = KS * BN * 2;   // two column blocks of KS x 64
constexpr int HALF_BYTES = 64 * ROWB;  // 64 rows of a column block
constexpr int BARRIERS = 2 * C_STAGES + 2 * AB_STAGES;
constexpr size_t SMEM = 1024 + (size_t)C_STAGES * C_BYTES +
                        (size_t)AB_STAGES * (A_BYTES + B_BYTES) +
                        8 * BARRIERS;
constexpr uint64_t SWIZZLE_128B = 1;   // wgmma descriptor layout code

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle code
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (SWIZZLE_128B << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across the fence, commit and wait
__device__ __forceinline__ void hold(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, fp32) += A (64 x 16) B (16 x 128); A K-major and B
// MN-major (the transpose bit) in shared memory.
__device__ __forceinline__ void wgmma_n128_tb(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the 128 threads of consumer warpgroup cw meet at barrier 1 + cw
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_update_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        const __grid_constant__ CUtensorMap mc, int M, int N,
                        int K, float alpha) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sC = (smem_u32(smem_raw) + 1023u) & ~1023u;  // + stage
  const uint32_t sA = sC + C_STAGES * C_BYTES;                // + stage
  const uint32_t sB = sA + AB_STAGES * A_BYTES;               // + stage
  const uint32_t bar_cf = sB + AB_STAGES * B_BYTES;  // C tile loaded
  const uint32_t bar_ce = bar_cf + 8 * C_STAGES;     // C stage free
  const uint32_t bar_abf = bar_ce + 8 * C_STAGES;    // A, B slice loaded
  const uint32_t bar_abe = bar_abf + 8 * AB_STAGES;  // A, B stage free
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nks = (K + KS - 1) / KS;  // K = 0: no slice, sums of +0

  if (threadIdx.x == 0) {
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(bar_cf + 8 * s, 1);
      mbar_init(bar_ce + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < AB_STAGES; ++s) {
      mbar_init(bar_abf + 8 * s, 1);
      mbar_init(bar_abe + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: each tile's C boxes, then its A and B slices; the ring
    // positions t (C) and v (A, B) run on across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int v = 0;
      for (int w = blockIdx.x, t = 0; w < tiles; w += gridDim.x, ++t) {
        const int row0 = w / tiles_n * BM, col0 = w % tiles_n * BN;
        // boxes wholly past M or N are not loaded (nor stored)
        const int halves = row0 + 64 < M ? 2 : 1;
        const int cbs = col0 + BOX < N ? 2 : 1;
        const int s = t % C_STAGES;
        mbar_wait(bar_ce + 8 * s, ((t / C_STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_cf + 8 * s, halves * cbs * HALF_BYTES);
        for (int cb = 0; cb < cbs; ++cb)
          for (int h = 0; h < halves; ++h)
            tma_load(sC + s * C_BYTES + cb * BM * ROWB + h * HALF_BYTES, &mc,
                     bar_cf + 8 * s, col0 + cb * BOX, row0 + h * 64);
        for (int ks = 0; ks < nks; ++ks, ++v) {
          const int u = v % AB_STAGES;
          mbar_wait(bar_abe + 8 * u, ((v / AB_STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_abf + 8 * u, A_BYTES + cbs * KS * ROWB);
          tma_load(sA + u * A_BYTES, &ma, bar_abf + 8 * u, ks * KS, row0);
          for (int cb = 0; cb < cbs; ++cb)
            tma_load(sB + u * B_BYTES + cb * KS * ROWB, &mb, bar_abf + 8 * u,
                     col0 + cb * BOX, ks * KS);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    const int quad = lane % 4;
    // the accumulator's rows: d[4i], d[4i+1] on row_a, d[4i+2], d[4i+3]
    // on row_a + 8 (rows of the tile); columns 8i + 2 quad and + 1
    const int row_a = cw * 64 + warp * 16 + lane / 4;
    float acc[64];
    int v = 0, held = -1;  // the C stage whose store may still read it
    for (int w = blockIdx.x, t = 0; w < tiles; w += gridDim.x, ++t) {
      const int row0 = w / tiles_n * BM, col0 = w % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < nks; ++ks, ++v) {
        const int u = v % AB_STAGES;
        mbar_wait(bar_abf + 8 * u, (v / AB_STAGES) & 1);
        const uint32_t a_rows = sA + u * A_BYTES + cw * 64 * ROWB;
        const uint32_t b_tile = sB + u * B_BYTES;
        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KS / 16; ++j)  // 16 k (32 bytes of a row) a step
          wgmma_n128_tb(acc, desc(a_rows + 32 * j, 16, 8 * ROWB),
                        desc(b_tile + j * 16 * ROWB, KS * ROWB, 8 * ROWB));
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_abe + 8 * u);
      }

      // the epilogue, in the C stage: c <- bf16_rn(fmaf(alpha, sum, c))
      const int s = t % C_STAGES;
      const uint32_t tile = sC + s * C_BYTES;
      mbar_wait(bar_cf + 8 * s, (t / C_STAGES) & 1);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r;
          // 128-byte swizzle: 16-byte chunk (i % 8) of the row lies at
          // chunk (i % 8) ^ (row % 8)
          const uint32_t addr = tile + (i / 8) * BM * ROWB + row * ROWB +
                                (((i % 8) ^ (row % 8)) << 4) + 4 * quad;
          __nv_bfloat162 c2;
          const uint32_t cv = ld_shared(addr);
          memcpy(&c2, &cv, sizeof(cv));
          const float2 cf = __bfloat1622float2(c2);
          const __nv_bfloat162 o2 =
              __floats2bfloat162_rn(fmaf(alpha, acc[4 * i + 2 * r], cf.x),
                                    fmaf(alpha, acc[4 * i + 2 * r + 1], cf.y));
          uint32_t ov;
          memcpy(&ov, &o2, sizeof(ov));
          st_shared(addr, ov);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(cw);  // the warpgroup's rows are in the stage
      if (t128 == 0) {
        if (row0 + cw * 64 < M) {
          for (int cb = 0; cb < 2; ++cb)
            if (col0 + cb * BOX < N)
              tma_store_box(&mc, tile + cb * BM * ROWB + cw * HALF_BYTES,
                            col0 + cb * BOX, row0 + cw * 64);
        }
        tma_store_commit();
        // the previous tile's store has read its stage: hand it back
        if (held >= 0) {
          tma_store_wait_read<1>();
          mbar_arrive(bar_ce + 8 * held);
        }
        held = s;
      }
    }
    if (t128 == 0) tma_store_wait_read<0>();  // stages stay until read
  }
}

// TMA's 2-D map of a rows x cols bf16 matrix (A, B or C) in 128-byte
// swizzled boxes of box_rows x 64, or false where TMA cannot address it
bool make_map_bf16(CUtensorMap* map, const void* ptr, int64_t ld, int rows,
                   int cols, int box_rows) {
  return make_map(map, ptr, ld, rows, cols, box_rows, BOX,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

int launch(const void* a, int64_t lda, const void* b, int64_t ldb, void* c,
           int64_t ldc, int M, int N, int K, float alpha, int tile,
           int64_t ctas, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tile != 0 || ctas <= 0 || ctas > tiles)
    return (int)cudaErrorInvalidValue;  // persistent: at most one per tile
  CUtensorMap ma, mb, mc;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  // K = 0 loads no slice of A or B
  if ((K > 0 && (!make_map_bf16(&ma, a, lda, M, K, BM) ||
                 !make_map_bf16(&mb, b, ldb, K, N, KS))) ||
      !make_map_bf16(&mc, c, ldc, M, N, 64))
    return (int)cudaErrorInvalidValue;  // the wrapper refuses these first
  cudaError_t err = cudaFuncSetAttribute(
      gemm_update_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_update_bf16_kernel<<<(unsigned)ctas, THREADS, SMEM,
                            (cudaStream_t)stream>>>(ma, mb, mc, M, N, K,
                                                    alpha);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int repro_gemm_update_f32(const void* a, int64_t lda,
                                     const void* b, int64_t ldb, void* c,
                                     int64_t ldc, int M, int N, int K,
                                     float alpha, int tile, int64_t ctas,
                                     void* stream) {
  return launch(a, lda, b, ldb, c, ldc, M, N, K, alpha, tile, ctas, stream);
}

extern "C" int repro_gemm_update_bf16(const void* a, int64_t lda,
                                      const void* b, int64_t ldb, void* c,
                                      int64_t ldc, int M, int N, int K,
                                      float alpha, int tile, int64_t ctas,
                                      void* stream) {
  return tc::launch(a, lda, b, ldb, c, ldc, M, N, K, alpha, tile, ctas,
                    stream);
}
