// STREAM's four kernels: copy (a), scale (alpha * c), add (a + b) and
// triad (b + alpha * c).
//
// Replaces the TPU kernel repro/kernels/stream.py:_run with its bodies
// _copy_kernel, _scale_kernel, _add_kernel and _triad_kernel.
//
// What bounds them on an H100: device memory, by design (STREAM measures
// it). At 2^28 fp32 elements copy and scale move 2 GiB (0.641 ms at
// 3.35 TB/s) and add and triad 3 GiB (0.961 ms), for at most two
// operations per element.
//
// Design: when every pointer is 16-byte aligned, the array is read as
// 16-byte vectors (4 fp32 or 8 bf16 values each), one per thread, THREADS
// per CTA, and the host sizes the grid (kernels/stream.py:stream_geometry):
// one CTA per THREADS vectors, the last CTA masked. A warp's load covers
// 512 contiguous bytes. The SMs take the CTAs in order, so the vectors in
// flight at any time form one window that sweeps through the arrays.
// Measured at 2^28 fp32 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// section 6): this design runs 0.996-1.004x the library's elementwise
// kernels; one resident wave of CTAs each walking a contiguous run, with 4
// vectors per thread in flight, ran 1.04-1.07x, the first port's
// grid-stride loop 1.04-1.06x, more vectors per thread and evict-first
// cache hints no faster. Otherwise (an operand off 16-byte alignment) a
// scalar grid-stride kernel does the same work one element per thread. No
// shared memory: nothing is reused.
//
// Math: each value is widened to fp32; scale is one rounded multiply, add
// one rounded addition, and triad a rounded multiply then a rounded
// addition (__fmul_rn / __fadd_rn keep the compiler from contracting them
// into one fused multiply-add), then cast once to the operand's type. So
// all four equal their plain PyTorch versions bit for bit. Copy moves the
// bits as they are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { COPY = 0, SCALE = 1, ADD = 2, TRIAD = 3 };
constexpr int THREADS = 256;  // 16-byte vectors per CTA, one per thread
constexpr int64_t SCALAR_BLOCKS = 132 * 32;  // the scalar path's grid-stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out element from x (and y): scale x, x + y, x + alpha * y
template <int OP>
__device__ __forceinline__ float apply(float x, float y, float alpha) {
  if (OP == SCALE) return __fmul_rn(alpha, x);
  if (OP == ADD) return __fadd_rn(x, y);
  return __fadd_rn(x, __fmul_rn(alpha, y));  // TRIAD
}

template <typename T, int OP>
__device__ __forceinline__ uint4 apply16(uint4 xs, uint4 ys, float alpha) {
  if constexpr (OP == COPY) {
    return xs;
  } else {
    constexpr int V = 16 / sizeof(T);
    const T* xe = reinterpret_cast<const T*>(&xs);
    const T* ye = reinterpret_cast<const T*>(&ys);
    uint4 os;
    T* oe = reinterpret_cast<T*>(&os);
#pragma unroll
    for (int k = 0; k < V; ++k)
      store_from_f32(oe + k, apply<OP>(to_f32(xe[k]), to_f32(ye[k]), alpha));
    return os;
  }
}

// Vector i = blockIdx.x * THREADS + threadIdx.x, those below nvec.
template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
stream_vec_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, int64_t nvec, float alpha) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const uint4 xs = reinterpret_cast<const uint4*>(x)[i];
  const uint4 ys = (OP == ADD || OP == TRIAD)
                       ? reinterpret_cast<const uint4*>(y)[i]
                       : xs;
  reinterpret_cast<uint4*>(out)[i] = apply16<T, OP>(xs, ys, alpha);
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
stream_scalar_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     T* __restrict__ out, int64_t n, float alpha) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (OP == COPY) {
      out[i] = x[i];
      continue;
    }
    const float yi = (OP == ADD || OP == TRIAD) ? to_f32(y[i]) : 0.f;
    store_from_f32(out + i, apply<OP>(to_f32(x[i]), yi, alpha));
  }
}

template <typename T, int OP>
int launch(const void* x, const void* y, void* out, int64_t n, float alpha,
           int64_t ctas, void* stream) {
  if (n <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)out |
                         ((OP == ADD || OP == TRIAD) ? (uintptr_t)y : 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (addr % 16 == 0 && n % V == 0) {
    // the host's grid must cover the vectors, with no CTA left empty
    const int64_t nvec = n / V;
    if (ctas <= 0 || ctas > INT32_MAX || ctas * THREADS < nvec ||
        (ctas - 1) * THREADS >= nvec)
      return (int)cudaErrorInvalidValue;
    stream_vec_kernel<T, OP><<<(int)ctas, THREADS, 0, s>>>(
        (const T*)x, (const T*)y, (T*)out, nvec, alpha);
  } else {
    const int64_t b = (n + THREADS - 1) / THREADS;
    stream_scalar_kernel<T, OP>
        <<<(int)(b < SCALAR_BLOCKS ? b : SCALAR_BLOCKS), THREADS, 0, s>>>(
            (const T*)x, (const T*)y, (T*)out, n, alpha);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int op, const void* x, const void* y, void* out, int64_t n,
             float alpha, int64_t ctas, void* stream) {
  switch (op) {
    case COPY: return launch<T, COPY>(x, y, out, n, alpha, ctas, stream);
    case SCALE: return launch<T, SCALE>(x, y, out, n, alpha, ctas, stream);
    case ADD: return launch<T, ADD>(x, y, out, n, alpha, ctas, stream);
    case TRIAD: return launch<T, TRIAD>(x, y, out, n, alpha, ctas, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// op: 0 copy (out = x), 1 scale (alpha * x), 2 add (x + y),
// 3 triad (x + alpha * y). y is read by add and triad only. On the vector
// path ctas CTAs of 256 16-byte vectors must cover the n elements with no
// CTA left empty; the scalar path (an operand off 16-byte alignment)
// ignores ctas.
extern "C" int repro_stream_f32(int op, const void* x, const void* y,
                                void* out, int64_t n, float alpha,
                                int64_t ctas, void* stream) {
  return dispatch<float>(op, x, y, out, n, alpha, ctas, stream);
}

extern "C" int repro_stream_bf16(int op, const void* x, const void* y,
                                 void* out, int64_t n, float alpha,
                                 int64_t ctas, void* stream) {
  return dispatch<__nv_bfloat16>(op, x, y, out, n, alpha, ctas, stream);
}
