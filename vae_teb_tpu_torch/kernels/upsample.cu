// Linear 2x upsampling along a sequence axis, and its gradient, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package upsamples with
// jax.image.resize(method="linear"), which XLA fuses into its neighbours.
// The port's decoder (models/blocks.py::linear_upsample, four calls a
// forward of SeqVaeTeb) used F.interpolate(mode="linear"), whose CUDA
// kernel (upsample_linear1d_out_frame) runs one thread per output position
// along the length, 600-4800 threads on 132 SMs, each looping over all
// B * C rows, and whose backward adds with atomics: at B=128 on an H100,
// 9.8 ms forward and 10.4 ms backward a training step, about 1% of the
// bytes bound.
//
// What bounds it on the card: bytes. Each input is read once and each
// output written once: at B=128 the decoder's four shapes move 299 MB each
// way, 0.089 ms at 3.35 TB/s. There is nothing to compute, so the design
// is a copy's: every shape fills the card (the grid follows the element
// count, 256 threads a block), neighbouring threads touch neighbouring
// addresses, and where a row's length is a multiple of 4 each thread moves
// 16-byte words.
//
// Layout: the wrapper (kernels/upsample.py) hands the kernels the input's
// physical layout as (outer, L, inner), contiguous, the output as (outer,
// 2L, inner) in the same layout. In the decoder the (B, S, C) input is the
// transposed view of a conv output, physically (B, C, S): outer = B * C,
// inner = 1, and each row is contiguous along the length.
//   - vec (inner = 1, L a multiple of 4, 16-byte aligned pointers): thread
//     t takes inputs 4q .. 4q + 3 of one row (one 16-byte load and its two
//     neighbours) and writes outputs 8q .. 8q + 7 (fp32 two 16-byte
//     stores, bf16 one); the gradient reads those eight outputs and their
//     two neighbours and writes the four inputs' gradients.
//   - otherwise one thread per input element, any inner.
//
// Arithmetic, accumulated in fp32 (x[i] clamped to the row at both ends):
//   fp32: exactly F.interpolate(mode="linear", align_corners=False) on the
//     card: output 2i = fma(1/4, x[i-1], 3/4 * x[i]), output 0 = fma(1,
//     x[0], 0 * x[1]); output 2i+1 = fma(3/4, x[i], 1/4 * x[i+1]) (PyTorch
//     computes w0 * a + w1 * b, which nvcc contracts to fma(w0, a, w1 * b)).
//   bf16: the blends written out as kernels/upsample.py's plain version does,
//     1/4 * x[i-1] + 3/4 * x[i] and 3/4 * x[i] + 1/4 * x[i+1], each product
//     and the sum rounded to fp32, then rounded once to bf16.
//   gradient, a gather with no atomics: dx[i] = 1/4 * (g[2i-1] + g[2i+2]) +
//     3/4 * (g[2i] + g[2i+1]), g's index clamped to [0, 2L-1] (so dx[0]
//     takes g[0] whole and dx[L-1] g[2L-1]), each sum and product rounded
//     to fp32, then to the storage type: kernels/upsample.py's plain
//     version in the same order, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// four consecutive values (16-byte aligned fp32, 8-byte aligned bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack2(q.x), b = unpack2(q.y);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                            pack2(v[2], v[3]));
}

// eight consecutive values, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float* v) {
  load4(p, v);
  load4(p + 4, v + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 a = unpack2(w[j]);
    v[2 * j] = a.x, v[2 * j + 1] = a.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  store4(p, v);
  store4(p + 4, v + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// output 2i from x[i-1], x[i], x[i+1] (clamped); first: i == 0
template <typename T>
__device__ __forceinline__ float even(bool first, float prev, float cur,
                                      float next) {
  if constexpr (std::is_same<T, float>::value) {
    return first ? __fmaf_rn(1.f, cur, __fmul_rn(0.f, next))
                 : __fmaf_rn(0.25f, prev, __fmul_rn(0.75f, cur));
  } else {
    return __fadd_rn(__fmul_rn(0.25f, prev), __fmul_rn(0.75f, cur));
  }
}

// output 2i + 1 from x[i], x[i+1] (clamped)
template <typename T>
__device__ __forceinline__ float odd(float cur, float next) {
  if constexpr (std::is_same<T, float>::value) {
    return __fmaf_rn(0.75f, cur, __fmul_rn(0.25f, next));
  } else {
    return __fadd_rn(__fmul_rn(0.75f, cur), __fmul_rn(0.25f, next));
  }
}

// dx[i] from g[2i-1], g[2i], g[2i+1], g[2i+2] (clamped)
__device__ __forceinline__ float gather(float prev_odd, float ev, float od,
                                        float next_even) {
  return __fadd_rn(__fmul_rn(0.25f, __fadd_rn(prev_odd, next_even)),
                   __fmul_rn(0.75f, __fadd_rn(ev, od)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_linear2x_fwd_vec(const T* __restrict__ x,
                              T* __restrict__ y, unsigned items,
                              unsigned L) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const unsigned quads = L >> 2, row = t / quads, i0 = (t - row * quads) << 2;
  const T* xr = x + (size_t)row * L;
  float v[6];   // x[i0-1 .. i0+4], clamped to the row
  load4(xr + i0, v + 1);
  v[0] = to_f32(xr[i0 ? i0 - 1 : 0]);
  v[5] = to_f32(xr[i0 + 4 < L ? i0 + 4 : L - 1]);
  float out[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = even<T>(i0 + j == 0, v[j], v[j + 1], v[j + 2]);
    out[2 * j + 1] = odd<T>(v[j + 1], v[j + 2]);
  }
  store8(y + (size_t)row * 2 * L + 2 * i0, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_linear2x_fwd_any(const T* __restrict__ x,
                              T* __restrict__ y, unsigned items,
                              unsigned L, unsigned inner) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const unsigned k = t % inner, oi = t / inner, i = oi % L, o = oi / L;
  const T* xr = x + (size_t)o * L * inner + k;
  const float prev = to_f32(xr[(size_t)(i ? i - 1 : 0) * inner]);
  const float cur = to_f32(xr[(size_t)i * inner]);
  const float next = to_f32(xr[(size_t)(i + 1 < L ? i + 1 : L - 1) * inner]);
  T* yr = y + (size_t)o * 2 * L * inner + k;
  put(yr + (size_t)2 * i * inner, even<T>(i == 0, prev, cur, next));
  put(yr + (size_t)(2 * i + 1) * inner, odd<T>(cur, next));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_linear2x_bwd_vec(const T* __restrict__ g,
                              T* __restrict__ dx, unsigned items,
                              unsigned L) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const unsigned quads = L >> 2, row = t / quads, i0 = (t - row * quads) << 2;
  const T* gr = g + (size_t)row * 2 * L;
  float w[10];   // g[2 i0 - 1 .. 2 i0 + 8], clamped to the row
  load8(gr + 2 * i0, w + 1);
  w[0] = to_f32(gr[i0 ? 2 * i0 - 1 : 0]);
  w[9] = to_f32(gr[i0 + 4 < L ? 2 * i0 + 8 : 2 * L - 1]);
  float out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = gather(w[2 * j], w[2 * j + 1], w[2 * j + 2], w[2 * j + 3]);
  store4(dx + (size_t)row * L + i0, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_linear2x_bwd_any(const T* __restrict__ g,
                              T* __restrict__ dx, unsigned items,
                              unsigned L, unsigned inner) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const unsigned k = t % inner, oi = t / inner, i = oi % L, o = oi / L;
  const T* gr = g + (size_t)o * 2 * L * inner + k;
  const float prev_odd = to_f32(gr[(size_t)(i ? 2 * i - 1 : 0) * inner]);
  const float ev = to_f32(gr[(size_t)2 * i * inner]);
  const float od = to_f32(gr[(size_t)(2 * i + 1) * inner]);
  const float next_even =
      to_f32(gr[(size_t)(i + 1 < L ? 2 * i + 2 : 2 * L - 1) * inner]);
  put(dx + (size_t)o * L * inner + (size_t)i * inner + k,
      gather(prev_odd, ev, od, next_even));
}

// One launch of the forward (bwd = 0) or the gradient on `stream`; returns
// the CUDA error (0 on success). vec needs inner == 1 and L % 4 == 0, and
// 16-byte aligned tensors; the thread count must fit 32 bits.
template <typename T>
int launch(bool bwd, const void* src, void* dst, long long outer, int L,
           int inner, int vec, void* stream) {
  if (outer < 0 || L < 1 || inner < 1 || (vec && (inner != 1 || L % 4)))
    return (int)cudaErrorInvalidValue;
  const long long items = vec ? outer * (L / 4) : outer * L * inner;
  if (items == 0) return 0;
  if (items > UINT_MAX - kThreads) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* in = static_cast<const T*>(src);
  T* out = static_cast<T*>(dst);
  if (bwd && vec)
    upsample_linear2x_bwd_vec<T><<<blocks, kThreads, 0, s>>>(in, out, items,
                                                         L);
  else if (bwd)
    upsample_linear2x_bwd_any<T><<<blocks, kThreads, 0, s>>>(in, out, items,
                                                         L, inner);
  else if (vec)
    upsample_linear2x_fwd_vec<T><<<blocks, kThreads, 0, s>>>(in, out, items,
                                                         L);
  else
    upsample_linear2x_fwd_any<T><<<blocks, kThreads, 0, s>>>(in, out, items,
                                                         L, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// x (outer, L, inner) -> y (outer, 2L, inner), both contiguous
extern "C" int upsample_linear2x_fwd_f32(const void* x, void* y,
                                         long long outer, int L, int inner,
                                         int vec, void* stream) {
  return launch<float>(false, x, y, outer, L, inner, vec, stream);
}

extern "C" int upsample_linear2x_fwd_bf16(const void* x, void* y,
                                          long long outer, int L, int inner,
                                          int vec, void* stream) {
  return launch<__nv_bfloat16>(false, x, y, outer, L, inner, vec, stream);
}

// g (outer, 2L, inner) -> dx (outer, L, inner), both contiguous
extern "C" int upsample_linear2x_bwd_f32(const void* g, void* dx,
                                         long long outer, int L, int inner,
                                         int vec, void* stream) {
  return launch<float>(true, g, dx, outer, L, inner, vec, stream);
}

extern "C" int upsample_linear2x_bwd_bf16(const void* g, void* dx,
                                          long long outer, int L, int inner,
                                          int vec, void* stream) {
  return launch<__nv_bfloat16>(true, g, dx, outer, L, inner, vec, stream);
}
