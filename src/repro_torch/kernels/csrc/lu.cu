// HPL's diagonal-block LU and its two panel solves, in fp32.
//
// Replace the TPU kernels repro/kernels/lu.py:lu_factor_block
// (_lu_block_kernel), :trsm_lower_left (_trsm_lower_kernel) and
// :trsm_upper_right (_trsm_upper_kernel).
//
// What bounds them on an H100: latency, not bytes or FLOPs. At HPL's b = 64
// the LU touches 16 KiB and does 2/3 b^3 = 0.17 MFLOP in b dependent steps;
// each panel solve reads a (64 x 16384) panel (4 MiB) and does b^2 = 4096
// FLOP per column, but as a chain of b dependent steps per column.
//
// - lu_factor_block, route warp_regs (n <= 64; all of HPL's calls): one
//   warp, no CTA barrier. The block, padded to 64 x 64 with an identity
//   block ([[A, 0], [0, I]], whose top-left n x n factors are A's), lives in
//   registers: each lane owns rows lane and lane + 32. A step costs a
//   shuffle of the pivot, an IEEE division per row (every lane divides its
//   own rows, side by side) and the FMAs, where the one-CTA kernel below
//   pays two barriers and shared-memory round trips. What the design had to
//   answer, measured with clock64 on the card: unrolling all 64 steps (so
//   that register indices are constants) made ~160 KB of straight-line code
//   that the warp fetched once, slower than the CTA kernel; so the rows
//   shift left by one position a step and k runs in a loop over groups of 8
//   steps of constant width (see lu_groups). A finished row takes no more
//   updates (predicated FMAs, no select) and is stored whole, as float4s,
//   when its slot is done; a division by garbage would take the slow path.
//   Loads are issued all at once, a full aligned block straight into
//   registers as float4s.
// - lu_factor_block, route cta_smem (64 < n <= 128): one CTA holds the
//   (n, n) block in shared memory (64 KiB at n = 128) and runs the steps
//   with a barrier between the pivot-column scaling and the rank-1 update
//   of each step. Registers cannot hold such a block on one warp.
// - trsm_lower_left, routes regs64 (n <= 64) and regs128 (n <= 128), one
//   template: each thread keeps one column of B in registers, padded to 64
//   or 128 rows (missing rows load as 0 and are not stored), and walks
//   right-looking, shifting as the LU does: once x_k is final it is stored
//   and x_i -= L[i][k] x_k for every i > k, with L's column k from shared
//   memory as float4 broadcasts. Every load of the column is issued before
//   the first FMA, so the panel streams at full memory parallelism. 128
//   columns per CTA: 128 CTAs of four warps for HPL's 16384 columns, one per
//   SM, where the left-looking kernel this replaces ran 64 CTAs and exposed
//   a shared-memory load on every term (64 and 32 columns per CTA measured
//   slower: each CTA stages L). The ragged last CTA masks its columns, so
//   any N works.
// - trsm_upper_right, routes regs64 (n <= 64) and regs128 (n <= 128), one
//   template, the lower solve's mirror image: X = B U^{-1}, one row of B per
//   thread in registers, padded to 64 or 128 columns (missing columns load
//   as 0 and are not stored), right-looking and shifting: x_k = x[0] /
//   U[k][k] is final (an IEEE division; a zero x[0], which `/` would send
//   down its slow path, takes its signed-zero quotient directly), then
//   x_j = fmaf(-x_k, U[k][j], x_j) for every j > k, with U's row k from
//   shared memory as float4 broadcasts. Each thread loads its own row, every
//   load in flight at once, as float4s where aligned (B arrives as a column
//   strip of HPL's matrix, row stride 16384); finished columns go through a
//   per-warp tile in shared memory and leave as 32-byte row pieces at the
//   end of every 8 steps. 128 rows per CTA: 128 CTAs for HPL's 16384 rows,
//   the last CTA masked, so any M works. On the card, loading each warp's
//   32 rows coalesced through the tile measured slower, and so did 64 rows
//   per CTA (PERF.md, section 6).
//   The first port's kernel, a slab of 256 rows per CTA (64 CTAs) solved
//   left-looking with both operands of every term read from shared memory,
//   ran 1.04x solve_triangular (NVIDIA H100 80GB HBM3, 700 W).
//
// Every sum runs in ascending index order, one fused multiply-add per term,
// and each element sees the same operations in the same order on every
// route (the LU: l = a[i][k] / pivot, then a[i][j] = fmaf(-l, a[k][j],
// a[i][j]) for k = 0, 1, ...; the lower solve: x_i = fmaf(-L[i][k], x_k,
// x_i) for k = 0, 1, ...; the upper solve: x_j = fmaf(-x_k, U[k][j], x_j)
// for k = 0, 1, ..., then x_j / U[j][j]), so the routes agree bit for bit,
// and with the first port's kernels. Divisions are IEEE (the build does not use fast
// math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;

// ---------------------------------------------------------------------------
// lu_factor_block
// ---------------------------------------------------------------------------

constexpr int LU_NP = 64;  // the warp route's padded block
// s's row pitch: lanes reading or writing their own rows (lane * 67 + j)
// hit 32 distinct banks, and with 67 = 3 mod 4 each U row's part from the
// diagonal on, s[k * 67 + k ...], starts 16-byte aligned
constexpr int LU_PITCH = LU_NP + 3;
constexpr int LU_GROUP = 8;      // warp_regs: steps per loop
constexpr int LU_THREADS = 256;  // cta_smem: 8 warps, 32 columns each

// Element i of a row held as float4s (16 of them at LU_NP = 64); with a
// constant i it names one register.
__device__ __forceinline__ float& elt(float4 (&r)[LU_NP / 4], int i) {
  float4& q = r[i / 4];
  return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

// Loads a float from global memory, always: a plain load whose value is
// used under a condition moves behind a branch, and then each row's loads
// wait for the previous row's.
__device__ __forceinline__ float load_always(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Loads 16 bytes from global memory, always (see load_always).
__device__ __forceinline__ float4 load4_always(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Stores the row a lane holds in r (positions 0..LU_NP - 1 - i holding
// columns i..LU_NP - 1 of row i) into row i of s, as float4s. A position
// past the row's end lands in s's padding (columns 64..66).
__device__ __forceinline__ void store_row(const float4 (&r)[LU_NP / 4], int i,
                                          float* __restrict__ s) {
  float4* dst = reinterpret_cast<float4*>(s + i * (LU_PITCH + 1));
#pragma unroll
  for (int q = 0; q < LU_NP / 4; ++q)
    if (4 * q < LU_NP - i) dst[q] = r[q];
}

// Steps K0 .. K0 + LU_GROUP - 1 of the warp route, then the later groups.
// Position c of a lane's row holds column k + c at step k: a step shifts
// the row left by one as it updates it, so every register index is a
// constant while k runs in a loop, and the loop body keeps the width the
// group's first step needs (W + 1 = LU_NP - K0 positions; those past the
// row's end hold garbage from columns >= 64).
// Rows lane (r0) and lane + 32 (r1): until step 32 the pivot row is an r0
// row and every r1 row lies below it; from step 32 on every r0 row is done.
// Step k: the pivot row's lane broadcasts it by shuffles; each row below
// the pivot divides its position 0 by the pivot (column k of L, written to
// s), then takes the rank-1 update and the shift in one predicated FMA per
// element. A row at or above the pivot takes no update, so it stays frozen
// from its own pivot step on: U's row, columns i..63 in positions
// 0..63 - i, written to s once, whole, when every row of its slot is done.
template <int K0>
__device__ __forceinline__ void lu_groups(float4 (&r0)[LU_NP / 4],
                                          float4 (&r1)[LU_NP / 4], int lane,
                                          float* __restrict__ s) {
  constexpr int W = LU_NP - K0 - 1;
  constexpr bool kPivotInR0 = K0 < 32;
  float4(&rp)[LU_NP / 4] = kPivotInR0 ? r0 : r1;  // the pivot row's slot
#pragma unroll 1
  for (int k = K0; k < K0 + LU_GROUP; ++k) {
    const int src = k % 32;  // the lane owning row k
    const float pivot = __shfl_sync(FULL_WARP, elt(rp, 0), src);
    const bool act0 = lane > k, act1 = kPivotInR0 || lane + 32 > k;
    // a frozen row divides its own U diagonal, a finite number, so every
    // division takes the fast path; only rows below the pivot use it
    float l0 = 0.f;
    if constexpr (kPivotInR0) {
      l0 = elt(r0, 0) / pivot;
      if (act0) s[lane * LU_PITCH + k] = l0;
    }
    const float l1 = elt(r1, 0) / pivot;
    if (act1) s[(lane + 32) * LU_PITCH + k] = l1;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float u = __shfl_sync(FULL_WARP, elt(rp, c + 1), src);
      if constexpr (kPivotInR0) {
        if (act0) elt(r0, c) = fmaf(-l0, u, elt(r0, c + 1));
      }
      if (act1) elt(r1, c) = fmaf(-l1, u, elt(r1, c + 1));
    }
  }
  if constexpr (K0 + LU_GROUP == 32) store_row(r0, lane, s);
  if constexpr (K0 + LU_GROUP < LU_NP)
    lu_groups<K0 + LU_GROUP>(r0, r1, lane, s);
  else
    store_row(r1, lane + 32, s);
}

// kFull: a full 64 x 64 block with 16-byte aligned rows (HPL's case),
// loaded by each lane straight into its two rows as float4s and stored as
// whole rows; otherwise loaded coalesced through s and padded with an
// identity block.
template <bool kFull>
__global__ void __launch_bounds__(32)
lu_warp_kernel(const float* __restrict__ A, int64_t lda,
               float* __restrict__ out, int n) {
  __shared__ __align__(16) float s[LU_NP * LU_PITCH];  // L\U out
  const int lane = threadIdx.x;
  float4 r0[LU_NP / 4], r1[LU_NP / 4];
  if constexpr (kFull) {
    const float4* a0 = reinterpret_cast<const float4*>(A + lane * lda);
    const float4* a1 = reinterpret_cast<const float4*>(A + (lane + 32) * lda);
#pragma unroll
    for (int q = 0; q < LU_NP / 4; ++q) {
      r0[q] = a0[q];
      r1[q] = a1[q];
    }
  } else {
    // every load in flight at once: rows past n re-read row n - 1 and
    // columns past n column n - 1, and the padding is selected after
    float v[LU_NP][2];
    const int c0 = min(lane, n - 1), c1 = min(lane + 32, n - 1);
#pragma unroll
    for (int i = 0; i < LU_NP; ++i) {
      const float* row = A + min(i, n - 1) * lda;
      v[i][0] = load_always(row + c0);  // coalesced: 32 of a row per load
      v[i][1] = load_always(row + c1);
    }
#pragma unroll
    for (int i = 0; i < LU_NP; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        s[i * LU_PITCH + j] = (i < n && j < n) ? v[i][h]
                                               : (i == j ? 1.f : 0.f);
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < LU_NP; ++j) {
      elt(r0, j) = s[lane * LU_PITCH + j];
      elt(r1, j) = s[(lane + 32) * LU_PITCH + j];
    }
    __syncwarp();
  }
  lu_groups<0>(r0, r1, lane, s);
  __syncwarp();
  if constexpr (kFull) {
#pragma unroll
    for (int i = 0; i < LU_NP; ++i) {
      out[i * LU_NP + lane] = s[i * LU_PITCH + lane];
      out[i * LU_NP + lane + 32] = s[i * LU_PITCH + lane + 32];
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      float* o = out + i * n;
      const float x0 = s[i * LU_PITCH + lane];
      const float x1 = s[i * LU_PITCH + lane + 32];
      if (lane < n) o[lane] = x0;
      if (lane + 32 < n) o[lane + 32] = x1;
    }
  }
}

__global__ void __launch_bounds__(LU_THREADS)
lu_cta_kernel(const float* __restrict__ A, int64_t lda,
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

// ---------------------------------------------------------------------------
// trsm_lower_left
// ---------------------------------------------------------------------------

constexpr int TRSM_COLS = 128;  // columns per CTA, one per thread
constexpr int TRSM_GROUP = 8;   // steps per loop

// Steps K0 .. K0 + TRSM_GROUP - 1 of the lower solve, then the later groups.
// As in lu_groups, position c holds row k + c at step k: a step stores
// x[0] = x_k, final, and shifts the rest left as it subtracts L[k + 1 + c][k]
// x_k, so the indices are constants, k runs in a loop, and the loop body
// keeps the group's first width W.
template <int NP, int K0>
__device__ __forceinline__ void trsm_groups(float (&x)[NP],
                                            const float4* __restrict__ lt4,
                                            float* __restrict__ X, int64_t j,
                                            int N, int n, bool col) {
  constexpr int W = NP - K0 - 1, P4 = (NP + 4) / 4;
#pragma unroll 1
  for (int k = K0; k < K0 + TRSM_GROUP; ++k) {
    const float xk = x[0];
    if (col && k < n) X[(int64_t)k * N + j] = xk;
    const float4* l = lt4 + k * P4;  // L[k + 1 + c][k] at c
#pragma unroll
    for (int g = 0; g < (W + 3) / 4; ++g) {
      const float4 l4 = l[g];
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * g + c < W) x[4 * g + c] = fmaf(-lv[c], xk, x[4 * g + c + 1]);
    }
  }
  if constexpr (K0 + TRSM_GROUP < NP)
    trsm_groups<NP, K0 + TRSM_GROUP>(x, lt4, X, j, N, n, col);
}

template <int NP>
__global__ void __launch_bounds__(TRSM_COLS)
trsm_lower_kernel(const float* __restrict__ LU, int64_t ldl,
                  const float* __restrict__ B, int64_t ldb,
                  float* __restrict__ X, int n, int N) {
  constexpr int P = NP + 4;  // lt's pitch: rows stay 16-byte aligned
  extern __shared__ float4 lt4[];
  float* lt = reinterpret_cast<float*>(lt4);  // lt[k * P + c] = L[k + 1 + c][k]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int64_t j = (int64_t)blockIdx.x * TRSM_COLS + t;
  const bool col = j < N;
  float x[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    x[i] = (col && i < n) ? B[(int64_t)i * ldb + j] : 0.f;
  // L's strict lower part, column k from row k + 1 on, while the column's
  // loads fly: each warp moves 8 (k) x 4 (i) tiles, reading 32-byte row
  // pieces, CHUNK loads in flight at a time
  constexpr int TILES = (NP / 8) * (NP / 4) / (TRSM_COLS / 32);  // a warp's
  constexpr int CHUNK = TILES < 32 ? TILES : 32;
#pragma unroll 1
  for (int c0 = 0; c0 < TILES; c0 += CHUNK) {
    float v[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int tile = (c0 + c) * (TRSM_COLS / 32) + warp;
      const int k = (tile % (NP / 8)) * 8 + lane / 4;
      const int i = (tile / (NP / 8)) * 4 + lane % 4;
      v[c] = (k < i && i < n) ? LU[(int64_t)i * ldl + k] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int tile = (c0 + c) * (TRSM_COLS / 32) + warp;
      const int k = (tile % (NP / 8)) * 8 + lane / 4;
      const int i = (tile / (NP / 8)) * 4 + lane % 4;
      if (k < i) lt[k * P + i - k - 1] = v[c];
    }
  }
  __syncthreads();
  trsm_groups<NP, 0>(x, lt4, X, j, N, n, col);
}

// ---------------------------------------------------------------------------
// trsm_upper_right
// ---------------------------------------------------------------------------

constexpr int UPPER_ROWS = 128;  // rows per CTA, one per thread
constexpr int UPPER_GROUP = 8;  // steps per loop

// x / d, IEEE, without `/` for a zero x: x / d is then the zero of sign
// (sign x) xor (sign d) for every d but 0 and NaN, and `/` would take its
// slow path (hundreds of cycles) on it; `/` divides 1 instead, unused. HPL's
// Left panel holds the diagonal block's own rows, whose solution, L, has
// 2,016 zeros above its diagonal in every iteration. The dividend is chosen
// in PTX: a select in C++ lets the compiler see that the quotient is unused
// where the dividend is 1, and divide x after all.
__device__ __forceinline__ float quotient(float x, float d) {
  const bool zero = x == 0.f && fabsf(d) > 0.f;  // false for a NaN d
  float num;
  asm("{\n .reg .pred zp;\n setp.ne.b32 zp, %2, 0;\n"
      " selp.f32 %0, 0f3F800000, %1, zp;\n}"
      : "=f"(num)
      : "f"(x), "r"((int)zero));
  const float q = num / d;
  return zero ? __int_as_float((__float_as_int(x) ^ __float_as_int(d)) &
                               0x80000000)
              : q;
}

// Steps K0 .. K0 + UPPER_GROUP - 1 of the upper solve, then the later
// groups: the lower solve's steps over a row. At step k position c of the
// row holds column k + c (c >= 1) and xk holds x_k, final: it is staged in
// the warp's tile for the store, every column right of it takes its term
// and shifts left by one, x[c] = fmaf(-U[k][k + 1 + c], x_k, x[c + 1]) with
// column k + 1 first, so the indices are constants while k runs in a loop
// and the loop body keeps the group's first width W; then x_{k+1} =
// x[0] / U[k+1][k+1] (quotient), last in the step, so its division shares
// a basic block with the step's FMAs. Step n - 1 only stages x_{n-1}. u0 is the
// first float4 of the step's U row, loaded a step ahead. At the end of a
// group the warp stores the group's columns of its 32 rows.
template <int NP, int K0>
__device__ __forceinline__ void upper_groups(
    float (&x)[NP], float& xk, float4& u0, const float4* __restrict__ ut4,
    const float* __restrict__ diag, float* __restrict__ tile,
    float* __restrict__ X, int64_t row0, int M, int n, int lane) {
  // P4: ut's pitch in float4s; TP: the tile's pitch (lanes writing their
  // own rows hit 32 banks)
  constexpr int W = NP - K0 - 1, P4 = (NP + 4) / 4, TP = NP + 1;
  if (K0 >= n) return;
  const int kend = K0 + UPPER_GROUP < n ? K0 + UPPER_GROUP : n;
#pragma unroll 1
  for (int k = K0; k < kend; ++k) {
    tile[lane * TP + k] = xk;
    if (k + 1 == n) break;
    const float4* u = ut4 + k * P4;  // U[k][k + 1 + c] at c
    const float4 un = u[P4];         // the next step's u0
    const float d = diag[k + 1];
#pragma unroll
    for (int g = 0; g < (W + 3) / 4; ++g) {
      const float4 u4 = g == 0 ? u0 : u[g];
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * g + c < W) x[4 * g + c] = fmaf(-uv[c], xk, x[4 * g + c + 1]);
    }
    xk = quotient(x[0], d);
    u0 = un;
  }
  // the group's columns: a lane stores column K0 + lane % G of rows
  // lane / G + R i, every shared-memory read first
  constexpr int G = UPPER_GROUP, R = 32 / G;
  __syncwarp();
  const int col = K0 + lane % G;
  float v[G];
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = tile[(lane / G + R * i) * TP + col];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int64_t r = row0 + lane / G + R * i;
    if (r < M && col < n) X[r * n + col] = v[i];
  }
  if constexpr (K0 + UPPER_GROUP < NP)
    upper_groups<NP, K0 + UPPER_GROUP>(x, xk, u0, ut4, diag, tile, X, row0,
                                       M, n, lane);
}

// One thread per row of B, UPPER_ROWS rows per CTA, the last CTA masked
// (its rows past M repeat row M - 1 and are not stored); columns past n
// load as 0, and U is padded with zeros (its diagonal with ones). kVec: the
// rows load as float4s.
template <int NP, bool kVec>
__global__ void __launch_bounds__(UPPER_ROWS)
trsm_upper_kernel(const float* __restrict__ LU, int64_t ldl,
                  const float* __restrict__ B, int64_t ldb,
                  float* __restrict__ X, int n, int M) {
  constexpr int P = NP + 4;  // ut's pitch: 16-byte rows
  extern __shared__ float4 smem4[];
  float* ut = reinterpret_cast<float*>(smem4);  // ut[k * P + c] = U[k][k+1+c]
  float* diag = ut + NP * P;                    // diag[k] = U[k][k]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* tile = diag + NP + warp * 32 * (NP + 1);  // the warp's rows of X
  const int64_t row0 = (int64_t)blockIdx.x * UPPER_ROWS + warp * 32;
  const int64_t last = (int64_t)M - 1;
  // U first (every CTA reads the same block, from L2), CHUNK loads in
  // flight per thread, all of ut written (zeros past U's rows) so that the
  // positions past a row's end hold finite values
  constexpr int UPT = NP * P / UPPER_ROWS, CHUNKS = (UPT + 35) / 36;
  constexpr int CHUNK = UPT / CHUNKS;
  static_assert(NP * P % UPPER_ROWS == 0 && CHUNK * CHUNKS == UPT, "U split");
  float w[CHUNK];
  const auto u_load = [&](int e0) {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int e = e0 + c * UPPER_ROWS + t, k = e / P, j = k + 1 + e % P;
      w[c] = load_always(LU + min(k, n - 1) * ldl + min(j, n - 1));
    }
  };
  const auto u_store = [&](int e0) {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int e = e0 + c * UPPER_ROWS + t, k = e / P, j = k + 1 + e % P;
      ut[e] = (k < n && j < n) ? w[c] : 0.f;
    }
  };
  const float dk = load_always(LU + min(t, n - 1) * (ldl + 1));
  u_load(0);
  // the thread's own row of B, every load in flight at once: as float4s
  // where rows are 16-byte aligned and n % 4 == 0 (kVec), else as floats
  float x[NP];
  const float* row = B + min(row0 + lane, last) * ldb;
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      const float4 f = load4_always(row + min(4 * q, n - 4));
      const bool in = 4 * q < n;
      x[4 * q] = in ? f.x : 0.f, x[4 * q + 1] = in ? f.y : 0.f;
      x[4 * q + 2] = in ? f.z : 0.f, x[4 * q + 3] = in ? f.w : 0.f;
    }
  } else {
    float v[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) v[c] = load_always(row + min(c, n - 1));
#pragma unroll
    for (int c = 0; c < NP; ++c) x[c] = c < n ? v[c] : 0.f;
  }
  u_store(0);
#pragma unroll 1
  for (int e0 = UPPER_ROWS * CHUNK; e0 < NP * P; e0 += UPPER_ROWS * CHUNK) {
    u_load(e0);
    u_store(e0);
  }
  if (t < NP) diag[t] = t < n ? dk : 1.f;
  for (int k = t + UPPER_ROWS; k < NP; k += UPPER_ROWS)  // 64 rows, NP 128
    diag[k] = k < n ? LU[(int64_t)k * (ldl + 1)] : 1.f;
  __syncthreads();
  float xk = quotient(x[0], diag[0]);
  float4 u0 = smem4[0];
  upper_groups<NP, 0>(x, xk, u0, smem4, diag, tile, X, row0, M, n, lane);
}

// Opts a kernel into more than the default 48 KiB of dynamic shared memory.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int NP>
cudaError_t launch_trsm_lower(const float* lu, int64_t ldl, const float* b,
                              int64_t ldb, float* x, int n, int N, int ctas,
                              cudaStream_t stream) {
  const size_t smem = (size_t)NP * (NP + 4) * sizeof(float);
  cudaError_t err = allow_smem(trsm_lower_kernel<NP>, smem);
  if (err != cudaSuccess) return err;
  trsm_lower_kernel<NP><<<ctas, TRSM_COLS, smem, stream>>>(lu, ldl, b, ldb,
                                                           x, n, N);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_trsm_upper(const float* lu, int64_t ldl, const float* b,
                              int64_t ldb, float* x, int n, int M, int ctas,
                              cudaStream_t stream) {
  const size_t smem =
      ((size_t)NP * (NP + 4) + NP + UPPER_ROWS * (NP + 1)) * sizeof(float);
  const bool vec = n % 4 == 0 && ldb % 4 == 0 && (uintptr_t)b % 16 == 0;
  auto kernel =
      vec ? trsm_upper_kernel<NP, true> : trsm_upper_kernel<NP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, UPPER_ROWS, smem, stream>>>(lu, ldl, b, ldb, x, n, M);
  return cudaGetLastError();
}

}  // namespace

// out (n x n, contiguous) = packed L\U of the (n x n) block at a (row stride
// lda). route 0 (warp_regs) takes n <= 64, route 1 (cta_smem) n <= 128.
extern "C" int repro_lu_factor_block_f32(const void* a, int64_t lda, void* out,
                                         int n, int route, void* stream) {
  if (n <= 0) return 0;
  if (route == 0) {
    if (n > LU_NP) return (int)cudaErrorInvalidValue;
    const bool full = n == LU_NP && lda % 4 == 0 && (uintptr_t)a % 16 == 0;
    if (full)
      lu_warp_kernel<true><<<1, 32, 0, (cudaStream_t)stream>>>(
          (const float*)a, lda, (float*)out, n);
    else
      lu_warp_kernel<false><<<1, 32, 0, (cudaStream_t)stream>>>(
          (const float*)a, lda, (float*)out, n);
    return (int)cudaGetLastError();
  }
  if (route != 1 || n > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * n * sizeof(float);
  cudaError_t err = allow_smem(lu_cta_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lu_cta_kernel<<<1, LU_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)a, lda, (float*)out, n);
  return (int)cudaGetLastError();
}

// x (n x N, contiguous) = L^{-1} b for the (n x N) panel b (row stride ldb),
// rows padded to np (64 or 128, n <= np); ctas CTAs of TRSM_COLS columns
// cover N, the last one masked.
extern "C" int repro_trsm_lower_left_f32(const void* lu, int64_t ldl,
                                         const void* b, int64_t ldb, void* x,
                                         int n, int N, int np, int ctas,
                                         void* stream) {
  if (n <= 0 || N <= 0) return 0;
  if (n > np || (int64_t)ctas * TRSM_COLS < N ||
      (int64_t)(ctas - 1) * TRSM_COLS >= N)
    return (int)cudaErrorInvalidValue;
  const float *l = (const float*)lu, *bb = (const float*)b;
  cudaStream_t s = (cudaStream_t)stream;
  if (np == 64)
    return (int)launch_trsm_lower<64>(l, ldl, bb, ldb, (float*)x, n, N, ctas,
                                      s);
  if (np == 128)
    return (int)launch_trsm_lower<128>(l, ldl, bb, ldb, (float*)x, n, N,
                                       ctas, s);
  return (int)cudaErrorInvalidValue;
}

// x (M x n, contiguous) = b U^{-1} for the (M x n) panel b (row stride
// ldb), columns padded to np (64 or 128, n <= np); ctas CTAs of UPPER_ROWS
// rows cover M, the last one masked.
extern "C" int repro_trsm_upper_right_f32(const void* lu, int64_t ldl,
                                          const void* b, int64_t ldb, void* x,
                                          int n, int M, int np, int ctas,
                                          void* stream) {
  if (n <= 0 || M <= 0) return 0;
  if (n > np || (int64_t)ctas * UPPER_ROWS < M ||
      (int64_t)(ctas - 1) * UPPER_ROWS >= M)
    return (int)cudaErrorInvalidValue;
  const float *l = (const float*)lu, *bb = (const float*)b;
  cudaStream_t s = (cudaStream_t)stream;
  if (np == 64)
    return (int)launch_trsm_upper<64>(l, ldl, bb, ldb, (float*)x, n, M, ctas,
                                      s);
  if (np == 128)
    return (int)launch_trsm_upper<128>(l, ldl, bb, ldb, (float*)x, n, M,
                                       ctas, s);
  return (int)cudaErrorInvalidValue;
}
