// ring_add_step: one ring hop's accumulate, out = float(acc) + float(recv)
// cast to acc's type, over a flat chunk of any length (fp32, bf16, fp16).
//
// Replaces the TPU kernel repro/kernels/ring.py:ring_add_step (body
// _add_kernel), which the reduce-scatter half of the engine's rs_ag, ring2d
// and int8_ef allreduce schedules runs once per hop on the chunk it
// received (repro/comm/engine.py:_fused_add).
//
// What bounds it on an H100: device memory. It reads two arrays and writes
// one for a single addition per element: 12 bytes per fp32 element (6 per
// bf16 or fp16) against one operation, far below the card's ridge point. A
// hop's chunk of a 32 MiB bucket on a ring of four (8 MiB per array) fits the
// 50 MB L2, so there the HBM bound does not bind; a 100 MB gradient leaf's
// chunk (25 MB per array) does not.
//
// Design: the STREAM add (stream.cu) with one change. On the TPU the
// kernel streamed receive buffer and accumulator through VMEM once,
// instead of materialising a sum and reading it back; here that is a
// grid-stride loop in which every thread reads 16 bytes of each operand,
// adds in fp32 and stores 16 bytes (4 fp32 or 8 bf16/fp16 values as one
// uint4) where all three pointers are 16-byte aligned, and finishes the
// elements past the last whole vector one at a time, so a chunk need not
// be a multiple of the reference's 128 lanes. The output may alias acc:
// each element is read and then written by the same thread, and no pointer
// is __restrict__, which is what lets the schedule accumulate into its
// chunk stack without a copy. The reference's (block_rows, 128) VMEM
// tiling is not carried over: no result depends on it.
//
// Math: one __fadd_rn per element (nothing can be contracted into it) and
// one rounding to the output type, as the plain version
// (acc.float() + recv.float()).to(acc.dtype): they agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 32;  // 32 blocks per SM, grid-stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_from_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

// VEC: 16-byte vectors over the whole vectors, then the tail one element at
// a time; otherwise every element one at a time.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ring_add_kernel(const T* acc, const T* recv, T* out, int64_t n) {
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int64_t nvec = n / V;
    const uint4* av = reinterpret_cast<const uint4*>(acc);
    const uint4* rv = reinterpret_cast<const uint4*>(recv);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int64_t i = first; i < nvec; i += stride) {
      const uint4 as = av[i];
      const uint4 rs = rv[i];
      const T* ae = reinterpret_cast<const T*>(&as);
      const T* re = reinterpret_cast<const T*>(&rs);
      uint4 os;
      T* oe = reinterpret_cast<T*>(&os);
#pragma unroll
      for (int k = 0; k < V; ++k)
        store_from_f32(oe + k, __fadd_rn(to_f32(ae[k]), to_f32(re[k])));
      ov[i] = os;
    }
    done = nvec * V;
  }
  for (int64_t i = done + first; i < n; i += stride)
    store_from_f32(out + i, __fadd_rn(to_f32(acc[i]), to_f32(recv[i])));
}

int blocks_for(int64_t work) {
  const int64_t b = (work + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

template <typename T>
int launch(const void* acc, const void* recv, void* out, int64_t n,
           void* stream) {
  if (n <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = (uintptr_t)acc | (uintptr_t)recv | (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (addr % 16 == 0) {
    ring_add_kernel<T, true><<<blocks_for(n / V > 0 ? n / V : n), THREADS,
                               0, s>>>((const T*)acc, (const T*)recv,
                                       (T*)out, n);
  } else {
    ring_add_kernel<T, false><<<blocks_for(n), THREADS, 0, s>>>(
        (const T*)acc, (const T*)recv, (T*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out[i] = acc[i] + recv[i] in fp32, rounded to the type; out may be acc.
extern "C" int repro_ring_add_f32(const void* acc, const void* recv,
                                  void* out, int64_t n, void* stream) {
  return launch<float>(acc, recv, out, n, stream);
}

extern "C" int repro_ring_add_bf16(const void* acc, const void* recv,
                                   void* out, int64_t n, void* stream) {
  return launch<__nv_bfloat16>(acc, recv, out, n, stream);
}

extern "C" int repro_ring_add_f16(const void* acc, const void* recv,
                                  void* out, int64_t n, void* stream) {
  return launch<__half>(acc, recv, out, n, stream);
}
