// O = softmax(Q K^T * hd^-1/2 [+ causal mask]) V with GQA, one pass over
// the keys with an online softmax: the prefill attention of the LM.
//
// Replaces the TPU kernel repro/kernels/attention.py:flash_attention
// (_flash_kernel). q is (B, Sq, H, hd); k and v are (B, Skv, KV, hd); the
// output is (B, Sq, H, hd) in q's type. Query head h reads key/value head
// h / (H / KV) of its own batch row.
//
// What bounds it on an H100: operations. At the serving path's prefill
// (B = 8, Sq = Skv = 1024, H = 24, KV = 8, hd = 128, causal) it does
// 4 * B * H * Sq * Skv * hd / 2 = 51.5 GFLOP against 0.2 GB of inputs and
// outputs: 0.77 ms at the 67 TFLOP/s fp32 rate, 0.06 ms at 3.35 TB/s. The
// arithmetic is fp32 (the reference casts q, k and v to fp32 and keeps
// S, P and the accumulators in fp32), so it runs on the fp32 pipes, not the
// tensor cores: TF32 would round the operands. A bf16 wgmma design that
// rounds P to bf16 is a different function and later work.
//
// Design: one 256-thread CTA per (batch * head, 64-row q tile), q tiles
// issued heaviest first (the causal diagonal's far end has the most key
// tiles). The CTA casts its q tile to fp32, scales it by hd^-1/2 (cast
// first, then scale, as the reference does) and keeps it in shared memory;
// then it walks the key tiles of 64 rows: K into shared memory, S = Q K^T
// (each thread a 4 x 4 block of S: rows ty*4.., columns tx + 16j, summed
// over hd in ascending order), the causal mask, the online-softmax update
// of the row max m and row sum l (reduced over the 16 threads of a half
// warp with shuffles), P into shared memory, then V into K's buffer and
// acc += P V (each thread 4 rows x hd/16 columns of acc in registers). The
// shared rows are padded to hd + 4 floats, so the column-strided K reads
// and the row-broadcast Q and P reads are free of bank conflicts. Tiles
// wholly above the causal diagonal (first key position past the tile's last
// query position, q_offset included) are never loaded. Masked scores are
// -1e30 as in the reference, so exp(-1e30 - m) is exactly 0 once a row has
// seen a real score (the first key tile always holds key 0); keys past Skv
// (a ragged last tile) get no weight at all. The output is
// acc / max(l, 1e-30), cast once. No fast math: expf and IEEE division.
// Shared memory is 85 KB at hd = 128 (dynamic; two CTAs per SM).
//
// The tiles are fixed here, not the reference's (bq, bk): the result does
// not depend on the tiling beyond fp32 rounding. q, k and v are read in
// their (B, S, heads, hd) layouts through their strides (unit stride on
// hd); the reference's transposes to (B * heads, S, hd) are index
// arithmetic here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx 4 key columns
constexpr int LDP = BK + 4;    // padded row of P
constexpr float MASKED = -1e30f;
constexpr unsigned NEG_INF_BITS = 0xff800000u;  // -inf

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  int64_t b, s, h;  // elements; hd has unit stride
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BQ * LDP);
}

// dst[r][d] = fp32(src[b, row0 + r, head, d]) * scale for r < valid, else 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int head,
                                          int row0, int valid, int rows,
                                          float scale) {
  constexpr int LD = HD + 4;
  const T* base = src + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < rows * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    if (r < valid) x = to_f32(base[(int64_t)(row0 + r) * st.s + d]) * scale;
    dst[r * LD + d] = x;
  }
}

// column of acc (and of V and O) held in the thread's slot c
template <int HD>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int CPT = HD / 16;
  constexpr int VEC = CPT >= 4 ? 4 : CPT;
  return (c / VEC) * (16 * VEC) + tx * VEC + (c % VEC);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int H, int KV, int Sq, int Skv, int causal,
                       int q_offset, float scale) {
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // BQ x LD, scaled fp32 q tile
  float* KVs = Qs + BQ * LD;     // BK x LD, K then V of one key tile
  float* Ps = KVs + BK * LD;     // BQ x LDP

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qrows = min(BQ, Sq - q0);

  load_tile<T, HD>(Qs, q, sq, b, h, q0, qrows, BQ, scale);

  // causal: keys past the tile's last query position carry no weight
  const int kv_end = causal ? min(Skv, q_offset + q0 + qrows) : Skv;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    const int kcols = min(BK, Skv - kv0);
    __syncthreads();  // the previous tile's reads of KVs and Ps are done
    load_tile<T, HD>(KVs, k, sk, b, kvh, kv0, kcols, BK, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float rmax = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (c >= kcols) s[i][j] = __uint_as_float(NEG_INF_BITS);  // past Skv
        else if (causal && kv0 + c > qpos) s[i][j] = MASKED;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // S is done with K; P is written
    load_tile<T, HD>(KVs, v, sv, b, kvh, kv0, kcols, BK, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          vv[c] = KVs[(kk + u) * LD + out_col<HD>(tx, c)];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                        : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= qrows) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store_from_f32(&ob[(int64_t)(q0 + r) * so.s + out_col<HD>(tx, c)],
                     acc[i][c] / lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int KV, int Sq,
           int Skv, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, KV,
      Sq, Skv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const int64_t* strides, int B, int H, int KV, int Sq, int Skv,
             int hd, int causal, int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Skv,
                           causal, q_offset, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Skv,
                           causal, q_offset, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, B, H, KV, Sq, Skv,
                            causal, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 — (batch, seq, head) element strides of q, k, v and o
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int64_t* strides, int B, int H,
                                         int KV, int Sq, int Skv, int hd,
                                         int causal, int q_offset,
                                         float scale, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, H, KV, Sq, Skv, hd, causal,
                         q_offset, scale, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const int64_t* strides, int B,
                                          int H, int KV, int Sq, int Skv,
                                          int hd, int causal, int q_offset,
                                          float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, Sq, Skv, hd,
                                 causal, q_offset, scale, stream);
}
