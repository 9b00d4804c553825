// O = softmax(Q K^T * hd^-1/2 [+ causal mask]) V with GQA, one pass over
// the keys with an online softmax: the prefill attention of the LM.
//
// Replaces the TPU kernel repro/kernels/attention.py:flash_attention
// (_flash_kernel). q is (B, Sq, H, hd); k and v are (B, Skv, KV, hd); the
// output is (B, Sq, H, hd) in q's type. Query head h reads key/value head
// h / (H / KV) of its own batch row. Two kernels, one per input type; the
// wrapper picks by dtype alone.
//
// The function is the reference's: q, k and v cast to fp32, q scaled by
// hd^-1/2, S, P, the row max m, the row sum l and the accumulator in fp32,
// masked scores -1e30, output acc / max(l, 1e-30) rounded once to q's
// type. No fast math: expf and IEEE division.
//
// What bounds it on an H100: operations. At the serving path's prefill
// (B = 8, Sq = Skv = 1024, H = 24, KV = 8, hd = 128, causal) the function
// is 4 * B * H * hd * (query, key) pairs = 51.5 GFLOP against 0.2 GB of
// inputs and outputs (0.06 ms at 3.35 TB/s): 0.77 ms on the 67 TFLOP/s
// fp32 pipes, 0.052 ms on the 989 TFLOP/s bf16 tensor cores.
//
// bf16 inputs (the serving path): flash_tc_kernel, on the tensor cores.
// Split-P argument: for bf16 q and k, S = Q K^T by wgmma on the bf16
// operands with fp32 accumulation is the reference's product up to the
// order of the fp32 sums (a product of two bf16 values is exact in fp32);
// the scale hd^-1/2 is applied to S in fp32 after the product, which
// moves S by one fp32 rounding. P stays fp32 for m, l and the mask; for
// P V it is split into P_hi = bf16_rn(P) and P_lo = bf16_rn(P - P_hi)
// (P - P_hi is exact in fp32), and acc += P_hi V + P_lo V with V bf16 and
// fp32 sums: |P - P_hi - P_lo| <= 2^-17 |P|, so the product is that of
// the fp32 P up to fp32-level rounding, not of a bf16 P. The split costs
// 1.5x the function's tensor-core work (77.3 GFLOP at the serving shape).
//
// Design: persistent CTAs, one per SM (a CTA's 225 KB of shared memory
// allows no second), each walking work items (batch * head, 128-row q
// tile), heaviest q tiles first. 384 threads: warpgroup 0 is the
// producer, in which one thread keeps TMA loads in flight: each item's Q
// once the previous item's last S has read it, and its K and V tiles of
// 128 keys through a 3-stage ring guarded by mbarriers (full K, full V and
// empty per stage), the ring running on across items so that the next
// item's first tiles load during this one's last products and its store.
// Warpgroups 1 and 2 each own 64 q rows of the item; setmaxnreg moves
// registers from the producer (40) to them (232). Per key tile a consumer
// runs S = Q K^T as hd/16 wgmma m64n128k16 (A and B K-major in shared
// memory), scales and masks S in registers (keys >= Skv always get no
// weight, -inf, since TMA fills rows past Skv with zeros, which would
// score 0; causally masked keys get -1e30; both tested, without branches,
// only on a tile that crosses the warpgroup's diagonal or Skv), takes the
// online-softmax step (row max and sum over the four threads of a quad),
// splits P into bf16 hi and lo in the A-operand register layout (the
// m64nNk16 accumulator's 8-column pairs are exactly the A fragment's
// registers), rescales acc and runs acc += P_hi V + P_lo V as
// 2 * 128/16 wgmma m64n{hd}k16 with A from registers and V MN-major (the
// transpose bit). The consumer pipelines one tile deep: S(n+1) and
// P(n) V(n) are issued together and the softmax of S(n+1) runs while
// P(n) V(n) is on the tensor cores (no branch between a wgmma and its
// wait, so ptxas keeps them asynchronous). What bounds it then is the
// softmax's instruction issue (IEEE expf, the split) and the K/V tiles'
// traffic from L2 (every CTA of a kv head re-reads its tiles), not the
// tensor cores. Tiles wholly above the diagonal (q_offset included) are
// never loaded; a warpgroup whose rows lie wholly below a loaded tile
// skips its math. TMA and wgmma share the swizzle: 128-byte rows (64
// bf16) for hd 64 and 128, 64-byte rows for hd 32, every tile 1024-byte
// aligned; hd 128 is loaded as two 64-column boxes. The tensor maps are
// built on the host from q's, k's and v's own (batch, seq, head) strides,
// the outer three dims ordered by stride; cuTensorMapEncodeTiled is
// reached through cudaGetDriverEntryPoint (no -lcuda). Rows past Sq are
// not stored. Shared memory: Q 32 KB + 3 x (K 32 + V 32) KB = 224 KB at
// hd 128 (dynamic).
//
// fp32 inputs (route simt_f32): flash_attention_kernel, a SIMT kernel on
// the fp32 pipes: fp32 operands cannot enter the bf16 tensor cores
// without changing the function, and TF32 (or a split of it) would round
// them. What bounds it is the FMA pipes (0.77 ms at the serving shape), so
// the design keeps them fed: loads overlap the math, no CTA-wide barrier
// stops the warps once a tile starts, and register blocks are large
// enough that shared memory does not set the pace.
//   - One CTA per (batch * head, 128-row q tile), heaviest first, one to
//     an SM (205 KB of shared memory at hd 128). Warpgroup 0 is the
//     producer: its 128 threads copy the q tile, then the K and V tiles
//     of 64 keys in turn, K(0), V(0), K(1), ..., into a ring of three
//     tile buffers, by cp.async (16-byte copies where the addresses and
//     strides allow, else 4-byte ones; rows past Skv land as zeros), each
//     fill completing on the slot's "full" mbarrier
//     (cp.async.mbarrier.arrive), each slot refilled once the eight
//     consumer warps have arrived on its "empty" one. So V(n) and K(n + 1)
//     are in flight while S(n) is summed. setmaxnreg moves registers from
//     the producer (40) to the consumers (232).
//   - Warpgroups 1 and 2 are the consumers. They scale the q tile by
//     hd^-1/2 in place once it has landed (cast first, then scale, as the
//     reference does), then each warp walks the key tiles on its own:
//     warp w owns q rows 16 w .. + 15, its half warp h the rows 16 w + h +
//     2 i (i < 8), and in S the keys tx + 16 j (j < 4) of lane tx of the
//     half: an 8 x 4 block of S, summed over hd in ascending order, one FMA
//     per product, and in acc the 8 rows by hd / 16 columns (8 at hd 128,
//     as float4 runs of 4). P's rows are the warp's own, so the softmax
//     and P V need only __syncwarp. A warp whose 16 rows all lie above a
//     key tile's first key skips that tile (releasing its slots), which
//     drops most of the causal diagonal's masked work.
//   - Per 4-deep step of Q K^T a thread reads 8 float4 of Q and 4 of K for
//     128 FMAs; per 4 keys of P V, 8 float4 of P and hd / 16 floats of V a
//     key as float4s (float2 at hd 32) for 32 * hd / 16 FMAs. A warp's Q
//     and P reads hit 2 rows one apart (one wavefront), its K reads 16
//     rows (two wavefronts, the least for 256 bytes), its V reads 256
//     contiguous bytes (two): 16 wavefronts per 128 warp-wide FMAs in
//     Q K^T and 24 per 256 in P V at hd 128, 8 and 10.7 FMAs a wavefront
//     (the first port's kernel reached 3.5 in P V with scalar V reads).
//   - Between the products (softmax_step): the mask, the online-softmax
//     update of m and l (row max and sum over the 16 lanes of a half warp
//     with shuffles), acc rescaled, P into shared memory (rows padded to
//     80 floats, so a warp's writes and float4 reads are conflict-free).
//     Only a tile that crosses Skv or the diagonal of the warp's first row
//     runs the mask: the warp picks one of the step's two instantiations
//     per tile.
// Shared rows of Q, K and V are padded to hd + 4 floats, so the
// column-strided K reads and the two-row Q reads are free of bank
// conflicts. Tiles wholly above the causal diagonal are never loaded.
// Masked scores are -1e30 as in the reference, so exp(-1e30 - m) is
// exactly 0 once a row has seen a real score (the first key tile always
// holds key 0), and a skipped tile would have added exactly 0; keys past
// Skv (a ragged last tile) get no weight at all.
//
// Neither kernel uses the reference's (bq, bk): the result does not
// depend on the tiling beyond fp32 rounding. q, k and v are read in their
// (B, S, heads, hd) layouts through their strides (unit stride on hd); the
// reference's transposes to (B * heads, S, hd) are index arithmetic here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 128;          // query rows per CTA
constexpr int BK = 64;           // key rows per tile
constexpr int PRODUCERS = 128;   // warpgroup 0: the copies
constexpr int CONSUMERS = 256;   // 16 half warps of 16 lanes
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int ROWS = BQ / 16;    // q rows a thread: 8
constexpr int KEYS = BK / 16;    // keys a thread: 4
constexpr int LDP = BK + 16;     // padded row of P
constexpr int BUFS = 3;          // the K/V ring: K(n), V(n), K(n + 1), ...
constexpr float MASKED = -1e30f;
constexpr unsigned NEG_INF_BITS = 0xff800000u;  // -inf


struct Strides {
  int64_t b, s, h;  // elements; hd has unit stride
};

template <int HD>
struct Simt {
  static constexpr int LD = HD + 4;    // padded row of Q, K and V
  static constexpr int TILE = BK * LD;  // floats of a K or V tile
  static constexpr int CPT = HD / 16;   // acc columns a thread
  static constexpr int VEC = CPT >= 4 ? 4 : CPT;  // of them contiguous
  static constexpr size_t FLOATS =
      (size_t)BQ * LD + (size_t)BUFS * TILE + (size_t)BQ * LDP;
  // + the mbarriers: Q's, then full and empty per ring slot
  static constexpr size_t SMEM = sizeof(float) * FLOATS + 8 * (1 + 2 * BUFS);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 4 or 16 bytes global -> shared; a source size of 0 fills zeros
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
// the mbarrier ``bar`` counts one arrival once every cp.async this thread
// has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// R rows of one head, src[r * stride + d] for r < R, into dst[r][d] (row
// pitch HD + 4), by the producer thread ``pt`` of PRODUCERS with cp.async:
// 16-byte copies where ``vec`` (the address and every stride in whole
// float4s), else 4-byte ones; rows r >= valid land as zeros.
template <int HD, int R>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int valid, bool vec,
                                          int pt) {
  constexpr int LD = HD + 4, CH = HD / 4;
#pragma unroll 4
  for (int i = 0; i < R * CH / PRODUCERS; ++i) {
    const int e = pt + PRODUCERS * i, r = e / CH, d = e % CH * 4;
    const bool ok = r < valid;
    const float* from = ok ? src + (int64_t)r * stride + d : src;
    const uint32_t to = smem_addr(dst + r * LD + d);
    if (vec) {
      cp_async16(to, from, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(to + 4 * j, ok ? from + j : src, ok);
    }
  }
}

// column of acc (and of V and O) held in the thread's slot c
template <int HD>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int VEC = Simt<HD>::VEC;
  return (c / VEC) * (16 * VEC) + tx * VEC + (c % VEC);
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// The online-softmax step on one key tile's S for a thread's 8 rows (rbase
// + 2 i, positions qpos0 + rbase + 2 i): with MASK, keys past Skv get no
// weight (-inf) and causally masked keys -1e30; then the row max and sum
// over the 16 lanes of a half warp, m and l updated, acc rescaled, and P
// into the warp's own rows of Ps.
template <bool MASK, int CPT>
__device__ __forceinline__ void softmax_step(float (&s)[ROWS][KEYS],
                                             float (&m)[ROWS],
                                             float (&l)[ROWS],
                                             float (&acc)[ROWS][CPT],
                                             float* Ps, int rbase, int tx,
                                             int qpos0, int kv0, int kcols,
                                             int causal) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float rmax = MASKED;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      if constexpr (MASK) {
        const int c = tx + 16 * j;
        if (c >= kcols) s[i][j] = __uint_as_float(NEG_INF_BITS);  // past Skv
        else if (causal && kv0 + c > qpos0 + rbase + 2 * i) s[i][j] = MASKED;
      }
      rmax = fmaxf(rmax, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(m[i], rmax);
    const float alpha = expf(m[i] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      s[i][j] = expf(s[i][j] - m_new);
      rsum += s[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l[i] = l[i] * alpha + rsum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
#pragma unroll
    for (int j = 0; j < KEYS; ++j)
      Ps[(rbase + 2 * i) * LDP + tx + 16 * j] = s[i][j];
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int H, int KV, int Sq, int Skv, int causal,
                       int q_offset, float scale, int vec) {
  using T = Simt<HD>;
  constexpr int LD = T::LD, CPT = T::CPT, VEC = T::VEC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // BQ x LD, scaled fp32 q tile
  float* ring = Qs + BQ * LD;         // BUFS x (BK x LD): slot z % BUFS
  float* Ps = ring + BUFS * T::TILE;  // BQ x LDP
  const uint32_t bar_q = smem_addr(smem + T::FLOATS);  // Q landed
  const uint32_t bar_full = bar_q + 8;                 // + 8 * slot
  const uint32_t bar_empty = bar_full + 8 * BUFS;      // + 8 * slot

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int qrows = min(BQ, Sq - q0);
  // causal: keys past the tile's last query position carry no weight
  const int kv_end = causal ? min(Skv, q_offset + q0 + qrows) : Skv;
  const int ntiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, PRODUCERS);
    for (int z = 0; z < BUFS; ++z) {
      mbar_init(bar_full + 8 * z, PRODUCERS);
      mbar_init(bar_empty + 8 * z, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < PRODUCERS) {
    // producer: Q, then the ring's tiles in turn, ring position z: K(z / 2)
    // for even z, V(z / 2) for odd z, each slot refilled once the eight
    // consumer warps have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x;
    copy_rows<HD, BQ>(Qs, q + b * sq.b + h * sq.h + (int64_t)q0 * sq.s, sq.s,
                      qrows, vec, pt);
    cp_async_arrive(bar_q);
    const float* kb = k + b * sk.b + kvh * sk.h;
    const float* vb = v + b * sv.b + kvh * sv.h;
    for (int z = 0; z < 2 * ntiles; ++z) {
      const int slot = z % BUFS, kv0 = z / 2 * BK;
      mbar_wait(bar_empty + 8 * slot, ((z / BUFS) & 1) ^ 1);
      if (z & 1)
        copy_rows<HD, BK>(ring + slot * T::TILE, vb + (int64_t)kv0 * sv.s,
                          sv.s, min(BK, Skv - kv0), vec, pt);
      else
        copy_rows<HD, BK>(ring + slot * T::TILE, kb + (int64_t)kv0 * sk.s,
                          sk.s, min(BK, Skv - kv0), vec, pt);
      cp_async_arrive(bar_full + 8 * slot);
    }
    cp_async_wait_all();  // no copy outlives the CTA
    return;
  }

  // consumers: no CTA-wide barrier after Q is scaled; each warp waits for
  // its tiles and releases them on its own, and its P rows are its own
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x - PRODUCERS, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32;
  // warp w owns rows 16 w .. + 15, its half warp h rows 16 w + h + 2 i
  const int rbase = 16 * (ty >> 1) + (ty & 1);
  mbar_wait(bar_q, 0);
  // cast, then scale, as the reference does
  for (int e = tid; e < BQ * HD / 4; e += CONSUMERS) {
    float4* p = reinterpret_cast<float4*>(Qs + e / (HD / 4) * LD +
                                          e % (HD / 4) * 4);
    const float4 x = *p;
    *p = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  float m[ROWS], l[ROWS], acc[ROWS][CPT];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int n = 0; n < ntiles; ++n) {
    const int kv0 = n * BK, kcols = min(BK, Skv - kv0);
    const int zk = 2 * n, zv = 2 * n + 1;
    if (causal && kv0 > q_offset + q0 + 16 * (ty >> 1) + 15) {
      // every key of the tile lies past the warp's last row: it would add
      // exactly 0 to the warp's rows; wait for each slot's fill (so that
      // its release counts for this use) and release it
      mbar_wait(bar_full + 8 * (zk % BUFS), (zk / BUFS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (zk % BUFS));
      mbar_wait(bar_full + 8 * (zv % BUFS), (zv / BUFS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (zv % BUFS));
      continue;
    }

    // S = Q K(n)^T: rows rbase + 2 i, keys tx + 16 j, summed over hd in
    // ascending order
    mbar_wait(bar_full + 8 * (zk % BUFS), (zk / BUFS) & 1);
    const float* Ks = ring + (zk % BUFS) * T::TILE;
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 kf[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(&Qs[(rbase + 2 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          float a = s[i][j];
          a = fmaf(qf.x, kf[j].x, a);
          a = fmaf(qf.y, kf[j].y, a);
          a = fmaf(qf.z, kf[j].z, a);
          a = fmaf(qf.w, kf[j].w, a);
          s[i][j] = a;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (zk % BUFS));  // K(n) read

    // the softmax step; only a tile that crosses Skv or the diagonal of
    // the warp's first row has keys to mask (the same for the whole warp)
    if (kv0 + BK > Skv ||
        (causal && kv0 + BK - 1 > q_offset + q0 + 16 * (ty >> 1)))
      softmax_step<true>(s, m, l, acc, Ps, rbase, tx, q_offset + q0, kv0,
                         kcols, causal);
    else
      softmax_step<false>(s, m, l, acc, Ps, rbase, tx, q_offset + q0, kv0,
                          kcols, causal);
    __syncwarp();  // the warp's P rows are written

    // acc += P V(n): rows rbase + 2 i, columns out_col(tx, c), keys in
    // ascending order; P four keys at a time, V a row of the thread's
    // columns at a time, both as vectors
    mbar_wait(bar_full + 8 * (zv % BUFS), (zv / BUFS) & 1);
    const float* Vs = ring + (zv % BUFS) * T::TILE;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &Ps[(rbase + 2 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
        const float* vrow = Vs + (kk + u) * LD;
#pragma unroll
        for (int g = 0; g < CPT / VEC; ++g) {
          const float* src = vrow + (g * 16 + tx) * VEC;
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[2 * g] = x.x;
            vv[2 * g + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float p = lane_of(p4[i], u);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncwarp();  // the warp is done with V(n) and with its P rows
    if (lane == 0) mbar_arrive(bar_empty + 8 * (zv % BUFS));
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = rbase + 2 * i;
    if (r >= qrows) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[(int64_t)(q0 + r) * so.s + out_col<HD>(tx, c)] = acc[i][c] / lc;
  }
}

// whether 16-byte copies can move q, k and v: addresses and (batch, seq,
// head) strides in whole float4s
bool vec_ok(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.s % 4 == 0 && st.h % 4 == 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KV, int Sq,
           int Skv, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Simt<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vec_ok(q, sq) && vec_ok(k, sk) && vec_ok(v, sv);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      H, KV, Sq, Skv, causal, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, Strides,
                       Strides, Strides, Strides, int, int, int, int, int,
                       int, int, float, cudaStream_t);

// Both routes' input contract: the shape checks, the 12 strides and the
// choice of head width. L32, L64 and L128 are the route's launchers.
template <Launch L32, Launch L64, Launch L128>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const int64_t* strides, int B, int H, int KV, int Sq, int Skv,
             int hd, int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Launch run = hd == 32 ? L32 : hd == 64 ? L64 : hd == 128 ? L128
                                                                 : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  return run(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Skv, causal, q_offset,
             scale, static_cast<cudaStream_t>(stream));
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;        // q rows per CTA: two consumer warpgroups
constexpr int BN = 128;        // keys per tile
constexpr int STAGES = 3;      // K/V ring
constexpr int THREADS = 384;   // producer warpgroup, then two consumers
constexpr int CONSUMER_WARPS = 8;  // barrier arrivals: one per warp

template <int HD>
struct Tile {
  static constexpr int ROWB = HD * 2 < 128 ? HD * 2 : 128;  // swizzled row
  static constexpr int BOX = ROWB / 2;       // bf16 columns per TMA box
  static constexpr int NCB = HD / BOX;       // column blocks
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  // descriptor layout code: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : 2;
  static constexpr int BARRIERS = 2 + 3 * STAGES;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
};

struct Geometry {
  int B, H, KV, Sq, Skv, causal, q_offset;
  float scale;
  int64_t ob, os, oh;  // output strides (elements)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// coordinate `pos` (1..3) of a box whose seq, head and batch coordinates sit
// at the positions packed in `order` (2 bits each)
__device__ __forceinline__ int coord(int order, int pos, int row, int head,
                                     int b) {
  return (order & 3) == pos ? row : ((order >> 2) & 3) == pos ? head : b;
}

// one TMA box (BOX columns x rows of one head of one batch row) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int order, uint32_t bar, int col,
                                         int row, int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(coord(order, 1, row, head, b)), "r"(coord(order, 2, row, head, b)),
      "r"(coord(order, 3, row, head, b))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle code
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across the fence, commit and wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, fp32) {+}= A (64 x 16) B (16 x 128); A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, registers) B (16 x 32); B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64); B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128); B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n32(d, a, b);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// P_hi = bf16_rn(p), P_lo = bf16_rn(p - P_hi) for two neighbouring columns
// (the lower column in the low half, as the A fragment wants)
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// S = Q K^T for one key tile: hd / 16 steps of 16 columns (32 bytes of a
// swizzled row each), committed as one group
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[BN / 2], uint32_t q_rows,
                                        uint32_t k_tile) {
  constexpr int ROWB = Tile<HD>::ROWB;
  hold(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    const int cb = j * 32 / ROWB, off = j * 32 % ROWB;
    wgmma_ss_n128(
        s, desc(q_rows + cb * BM * ROWB + off, 16, 8 * ROWB, Tile<HD>::SWIZZLE),
        desc(k_tile + cb * BN * ROWB + off, 16, 8 * ROWB, Tile<HD>::SWIZZLE),
        j > 0);
  }
  wgmma_commit();
}

// acc += P_hi V + P_lo V for one key tile: 16 keys a step, V MN-major,
// committed as one group
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&p_hi)[BN / 16][4],
                                         uint32_t (&p_lo)[BN / 16][4],
                                         uint32_t v_tile) {
  constexpr int ROWB = Tile<HD>::ROWB;
  hold(acc);
  hold(p_hi);
  hold(p_lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv =
        desc(v_tile + kk * 16 * ROWB, BN * ROWB, 8 * ROWB, Tile<HD>::SWIZZLE);
    wgmma_rs<HD>(acc, p_hi[kk], dv);
    wgmma_rs<HD>(acc, p_lo[kk], dv);
  }
  wgmma_commit();
}

// the online-softmax step on one tile's S, in place: scale, mask (keys past
// Skv get -inf, causally masked ones -1e30, tested only on a tile that
// crosses this warpgroup's diagonal or Skv), the new row max m, alpha =
// exp(m_old - m), S <- P = exp(S - m) and the rows' sums of P
__device__ __forceinline__ void softmax_exp(float (&s)[BN / 2], float (&m)[2],
                                            float (&alpha)[2],
                                            float (&rsum)[2],
                                            const Geometry& g, int kv0,
                                            int first, int row_a, int quad) {
  const bool edge =
      kv0 + BN > g.Skv || (g.causal && kv0 + BN - 1 > g.q_offset + first);
  // on an edge tile, row r keeps the columns c < keep[r] of the tile;
  // columns c >= past_skv lie past Skv
  const int past_skv = g.Skv - kv0;
  int keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    keep[r] = g.causal ? min(past_skv, g.q_offset + row_a + 8 * r - kv0 + 1)
                       : past_skv;
  float rmax[2] = {MASKED, MASKED};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * g.scale;
      const int c = 8 * i + 2 * quad + (e & 1);
      if (edge && c >= keep[e >> 1])
        x = c >= past_skv ? __uint_as_float(NEG_INF_BITS) : MASKED;
      s[4 * i + e] = x;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    const float m_new = fmaxf(m[r], rmax[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    rsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = expf(s[i] - m[(i >> 1) & 1]);
    rsum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
  }
}

// l <- l alpha + rowsum, acc <- acc alpha, and P (in s) split into bf16 hi
// and lo A fragments
template <int HD>
__device__ __forceinline__ void rescale_split(const float (&s)[BN / 2],
                                              float (&acc)[HD / 2],
                                              float (&l)[2],
                                              const float (&alpha)[2],
                                              const float (&rsum)[2],
                                              uint32_t (&p_hi)[BN / 16][4],
                                              uint32_t (&p_lo)[BN / 16][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], p_hi[kk][j],
            p_lo[kk][j]);
}

// one work item: a (batch * head, 128-row q tile) pair, heaviest first
struct Item {
  int b, h, q0, ntiles;
};

__device__ __forceinline__ Item item_of(int w, const Geometry& g) {
  const int bh = w % (g.B * g.H);
  const int nqt = (g.Sq + BM - 1) / BM;
  Item it;
  it.b = bh / g.H;
  it.h = bh % g.H;
  it.q0 = (nqt - 1 - w / (g.B * g.H)) * BM;
  const int qrows = min(BM, g.Sq - it.q0);
  // causal: keys past the tile's last query position carry no weight
  const int kv_end = g.causal ? min(g.Skv, g.q_offset + it.q0 + qrows) : g.Skv;
  it.ntiles = (kv_end + BN - 1) / BN;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, int order_q,
                int order_k, int order_v, __nv_bfloat16* __restrict__ o,
                Geometry g) {
  using T = Tile<HD>;
  constexpr int ROWB = T::ROWB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;              // + stage * KV_BYTES
  const uint32_t sV = sK + STAGES * T::KV_BYTES;    // + stage * KV_BYTES
  const uint32_t bar_q = sV + STAGES * T::KV_BYTES; // Q loaded
  const uint32_t bar_qe = bar_q + 8;                // Q no longer read
  const uint32_t bar_k = bar_qe + 8;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_e = bar_v + 8 * STAGES;
  const int items = g.B * g.H * ((g.Sq + BM - 1) / BM);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q of each item once the last one's is released, then its K
    // and V tiles through the ring (ring positions run on across items)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int t = 0, k = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++k) {
        const Item it = item_of(w, g);
        const int kvh = it.h / (g.H / g.KV);
        if (k > 0) mbar_wait(bar_qe, (k - 1) & 1);
        mbar_expect_tx(bar_q, T::Q_BYTES);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(sQ + cb * BM * ROWB, &tq, order_q, bar_q, cb * T::BOX,
                   it.q0, it.h, it.b);
        for (int n = 0; n < it.ntiles; ++n, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * s, T::KV_BYTES);
          for (int cb = 0; cb < T::NCB; ++cb)
            tma_load(sK + s * T::KV_BYTES + cb * BN * ROWB, &tk, order_k,
                     bar_k + 8 * s, cb * T::BOX, n * BN, kvh, it.b);
          mbar_expect_tx(bar_v + 8 * s, T::KV_BYTES);
          for (int cb = 0; cb < T::NCB; ++cb)
            tma_load(sV + s * T::KV_BYTES + cb * BN * ROWB, &tv, order_v,
                     bar_v + 8 * s, cb * T::BOX, n * BN, kvh, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int quad = lane % 4;
    const uint32_t q_rows = sQ + cw * 64 * ROWB;
    const auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float acc[HD / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m[2], l[2], alpha[2], rsum[2];
    // P in the A-fragment layout: register j of step kk holds columns
    // 16kk + 8(j/2) + 2 quad, +1 of row row_a + 8(j%2)
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];

    int tile = 0;  // ring position of the item's first key tile
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const Item it = item_of(w, g);
      // the accumulators' rows: d[4i], d[4i+1] on row_a, d[4i+2], d[4i+3]
      // on row_a + 8; columns 8i + 2 quad and 8i + 2 quad + 1
      const int first = it.q0 + cw * 64;  // this warpgroup's first q row
      const int row_a = first + warp * 16 + lane / 4;
      // key tiles this warpgroup's rows see; the item's later tiles are
      // only released
      const int seen =
          first >= g.Sq ? 0
          : g.causal    ? min(it.ntiles, (g.q_offset + first + 63) / BN + 1)
                        : it.ntiles;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = MASKED;
      l[0] = l[1] = 0.f;

      // Software pipeline: S(0) = Q K(0)^T first; then per tile n, S(n+1)
      // and acc += P(n) V(n) are issued together, and the softmax of
      // S(n+1) (max, exp, row sums, in place) runs while P(n) V(n) is
      // still on the tensor cores; then acc is rescaled and P(n+1) split
      // into its registers; the last P V closes. No branch separates a
      // wgmma from its wait, so ptxas keeps them asynchronous.
      mbar_wait(bar_q, k & 1);
      if (seen > 0) {
        mbar_wait(bar_k + 8 * (tile % STAGES), (tile / STAGES) & 1);
        issue_s<HD>(s, q_rows, sK + (tile % STAGES) * T::KV_BYTES);
        wgmma_wait<0>();
        hold(s);
        softmax_exp(s, m, alpha, rsum, g, 0, first, row_a, quad);
        rescale_split<HD>(s, acc, l, alpha, rsum, p_hi, p_lo);
        for (int n = 0; n + 1 < seen; ++n) {
          const int t0 = tile + n, t1 = t0 + 1;
          mbar_wait(bar_k + 8 * (t1 % STAGES), (t1 / STAGES) & 1);
          issue_s<HD>(s, q_rows, sK + (t1 % STAGES) * T::KV_BYTES);
          mbar_wait(bar_v + 8 * (t0 % STAGES), (t0 / STAGES) & 1);
          issue_pv<HD>(acc, p_hi, p_lo, sV + (t0 % STAGES) * T::KV_BYTES);
          wgmma_wait<1>();  // S(n+1) is done; P(n) V(n) may still run
          hold(s);
          softmax_exp(s, m, alpha, rsum, g, (n + 1) * BN, first, row_a,
                      quad);
          wgmma_wait<0>();
          hold(acc);
          hold(p_hi);
          hold(p_lo);
          release(bar_e + 8 * (t0 % STAGES));
          rescale_split<HD>(s, acc, l, alpha, rsum, p_hi, p_lo);
        }
        release(bar_qe);  // the item's last S is done: Q may be replaced
        const int tn = tile + seen - 1;
        mbar_wait(bar_v + 8 * (tn % STAGES), (tn / STAGES) & 1);
        issue_pv<HD>(acc, p_hi, p_lo, sV + (tn % STAGES) * T::KV_BYTES);
        wgmma_wait<0>();
        hold(acc);
        hold(p_hi);
        hold(p_lo);
        release(bar_e + 8 * (tn % STAGES));
      } else {
        release(bar_qe);
      }
      for (int n = seen; n < it.ntiles; ++n) {
        const int tn = tile + n;
        mbar_wait(bar_k + 8 * (tn % STAGES), (tn / STAGES) & 1);
        mbar_wait(bar_v + 8 * (tn % STAGES), (tn / STAGES) & 1);
        release(bar_e + 8 * (tn % STAGES));
      }
      tile += it.ntiles;

      if (seen > 0) {
        __nv_bfloat16* ob = o + it.b * g.ob + it.h * g.oh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r;
          if (row >= g.Sq) continue;
          const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
          for (int i = 0; i < HD / 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + (int64_t)row * g.os + 8 * i + 2 * quad) =
                __floats2bfloat162_rn(acc[4 * i + 2 * r] / lc,
                                      acc[4 * i + 2 * r + 1] / lc);
        }
      }
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

// 4-D tensor map of a (batch, seq, head, hd) bf16 tensor with element
// strides st: hd innermost, the other three ordered by stride (a dim of
// size 1 last); the box is box_cols x rows of one head of one batch row.
// *order gets the positions of the seq, head and batch coordinates.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, Strides st,
              int seq, int heads, int batch, int box_cols, int rows,
              CUtensorMapSwizzle swizzle, int hd, int* order) {
  struct Dim {
    uint64_t size, stride;
    int what;  // 0 seq, 1 head, 2 batch
  } d[3] = {{(uint64_t)seq, (uint64_t)st.s, 0},
            {(uint64_t)heads, (uint64_t)st.h, 1},
            {(uint64_t)batch, (uint64_t)st.b, 2}};
  uint64_t span = (uint64_t)hd;
  for (const Dim& x : d)
    if (x.size > 1 && x.size * x.stride > span) span = x.size * x.stride;
  span = (span + 7) / 8 * 8;
  for (Dim& x : d)
    if (x.size == 1) x.stride = span;  // never stepped: any valid stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)hd, d[0].size, d[1].size, d[2].size};
  cuuint64_t strides[3] = {d[0].stride * 2, d[1].stride * 2,
                           d[2].stride * 2};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].what == 0) box[1 + i] = rows;
    *order |= (1 + i) << (2 * d[i].what);
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
              int KV, int Sq, int Skv, int causal, int q_offset, float scale,
              cudaStream_t stream) {
  using T = Tile<HD>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle sw = T::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  int oq, ok, ov;
  if (!make_map(enc, &mq, q, sq, Sq, H, B, T::BOX, BM, sw, HD, &oq) ||
      !make_map(enc, &mk, k, sk, Skv, KV, B, T::BOX, BN, sw, HD, &ok) ||
      !make_map(enc, &mv, v, sv, Skv, KV, B, T::BOX, BN, sw, HD, &ov))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const Geometry g{B, H, KV, Sq, Skv, causal, q_offset, scale,
                   so.b, so.s, so.h};
  // persistent: one CTA per SM (the shared memory allows no second), each
  // walking the items w = blockIdx.x, + gridDim.x, ...
  const int items = B * H * ((Sq + BM - 1) / BM);
  const int ctas = items < sms ? items : sms;
  flash_tc_kernel<HD><<<ctas, THREADS, T::SMEM, stream>>>(
      mq, mk, mv, oq, ok, ov, static_cast<__nv_bfloat16*>(o), g);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// strides: 12 int64 — (batch, seq, head) element strides of q, k, v and o
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int64_t* strides, int B, int H,
                                         int KV, int Sq, int Skv, int hd,
                                         int causal, int q_offset,
                                         float scale, void* stream) {
  return dispatch<launch<32>, launch<64>, launch<128>>(
      q, k, v, o, strides, B, H, KV, Sq, Skv, hd, causal, q_offset, scale,
      stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const int64_t* strides, int B,
                                          int H, int KV, int Sq, int Skv,
                                          int hd, int causal, int q_offset,
                                          float scale, void* stream) {
  return dispatch<tc::launch_tc<32>, tc::launch_tc<64>, tc::launch_tc<128>>(
      q, k, v, o, strides, B, H, KV, Sq, Skv, hd, causal, q_offset, scale,
      stream);
}
