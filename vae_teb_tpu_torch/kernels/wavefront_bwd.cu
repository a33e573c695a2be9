// Reverse wavefront LSTM recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel vae_teb_tpu/models/wavefront_pallas.py::_bwd_kernel
// (launched by wavefront_bwd_pallas): the backward of the forward wavefront
// in wavefront_fwd.cu. Reverse step k = K-1 ... 0, per batch row, with the
// carried cotangents (dh, dc):
//
//   dh_tot = dh + dY[k]
//   i, f, g, o recomputed from the stored pre-activation gates_seq[k]
//   tc = tanh(c_seq[k]),  do = dh_tot * tc
//   dct = dc + dh_tot * o * (1 - tc^2)
//   dgates = [dct*g*i*(1-i), dct*c_prev*f*(1-f), dct*i*(1-g^2), do*o*(1-o)]
//   dgates = 0 for the columns of units that are invalid at step k
//            (valid: lvec[u] <= k < S + lvec[u])
//   dz = dgates @ W_eff^T                       (fp32 accumulate)
//   dh' = dz + (invalid ? dh_tot : 0),  dc' = valid ? dct * f : dc
//
// An invalid unit's own dgates are zero, but it still receives the feed
// cotangent of unit v+1 through dz, and its carried dh_tot and dc pass
// through. Outputs: dgates_seq (K, B, 4UH), which is the cotangent of
// xs_wave and feeds the weight-gradient GEMM outside the kernel, and the
// final dh, dc (the cotangents of h0, c0).
//
// Rounding points follow the TPU kernel: dh and dc are kept in the storage
// type (rounded after every step), the cell math is fp32 on the storage
// values, the dgates are rounded to the storage type before they are
// stored and before the dz product, and dz accumulates in fp32. The
// activations are recomputed from the stored (rounded) gates.
// kernels/wavefront_ref.py::wavefront_bwd_plain is the same computation in
// plain PyTorch. __fmul_rn / __fadd_rn keep nvcc from contracting the
// elementwise chain into FMAs that the plain version does not do.
//
// Design (simple first version, the mirror of the forward kernel). One
// block owns one batch row for all K steps; thread t owns state column t
// (dh, dc in registers) and computes the four dgates of column t. The
// row's 4UH dgates go to shared memory, double-buffered (2 x 8 KB in fp32
// at UH = 512), so each step needs one __syncthreads; then thread t forms
// dz[t] as a 4UH-term dot product against column t of the contiguous
// W_eff^T (4UH, UH), so a warp reads 32 neighbouring addresses of one row.
// What bounds it on the card: every block streams all of W_eff^T (4 MB in
// fp32 at UH = 512) from L2 once per step, like the forward, so the time is
// roughly K * |W_eff| / (one SM's L2 bandwidth), nearly independent of B
// while B stays under the SM count. Keeping W_eff^T slices resident in
// shared memory across a thread-block cluster (DSMEM exchange of dgates)
// and skipping its zero blocks are later work.
//
// Plain C interface: each entry point launches on the given stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the storage type and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x * y * (1 - y), evaluated left to right without contraction
__device__ __forceinline__ float mul_dsig(float x, float y) {
  return __fmul_rn(__fmul_rn(x, y), __fsub_rn(1.0f, y));
}

template <typename T>
__global__ void wavefront_bwd_kernel(const T* __restrict__ wt,
                                     const T* __restrict__ gates_seq,
                                     const T* __restrict__ c_seq,
                                     const T* __restrict__ c_prev_seq,
                                     const T* __restrict__ dy,
                                     const T* __restrict__ dh0,
                                     const T* __restrict__ dc0,
                                     const int* __restrict__ lvec,
                                     T* __restrict__ dgates_seq,
                                     T* __restrict__ dh_fin,
                                     T* __restrict__ dc_fin,
                                     int K, int B, int UH, int H, int S) {
  extern __shared__ float dg_buf[];  // 2 * 4UH floats: dgates of two steps
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int G = 4 * UH;
  const bool owner = t < UH;

  float dh = 0.f, dc = 0.f;
  int layer = 0;
  if (owner) {
    dh = load_f32(dh0 + (size_t)row * UH + t);
    dc = load_f32(dc0 + (size_t)row * UH + t);
    layer = lvec[t / H];
  }

  for (int k = K - 1; k >= 0; --k) {
    float* dg = dg_buf + (k & 1) * G;
    const bool valid = layer <= k && k < S + layer;
    float dh_tot = 0.f, dct = 0.f, fg = 0.f;
    if (owner) {
      const size_t s_off = ((size_t)k * B + row) * UH + t;
      const T* gk = gates_seq + ((size_t)k * B + row) * G + t;
      dh_tot = __fadd_rn(dh, load_f32(dy + s_off));
      const float ig = sigmoid(load_f32(gk));
      fg = sigmoid(load_f32(gk + UH));
      const float gt = tanhf(load_f32(gk + 2 * UH));
      const float og = sigmoid(load_f32(gk + 3 * UH));
      const float tc = tanhf(load_f32(c_seq + s_off));
      const float cprev = load_f32(c_prev_seq + s_off);
      const float d_o = __fmul_rn(dh_tot, tc);
      dct = __fadd_rn(dc, __fmul_rn(__fmul_rn(dh_tot, og),
                                    __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      float dgi = 0.f, dgf = 0.f, dgg = 0.f, dgo = 0.f;
      if (valid) {
        dgi = round_to(mul_dsig(__fmul_rn(dct, gt), ig), dh0);
        dgf = round_to(mul_dsig(__fmul_rn(dct, cprev), fg), dh0);
        dgg = round_to(__fmul_rn(__fmul_rn(dct, ig),
                                 __fsub_rn(1.0f, __fmul_rn(gt, gt))), dh0);
        dgo = round_to(mul_dsig(d_o, og), dh0);
      }
      dg[t] = dgi;
      dg[UH + t] = dgf;
      dg[2 * UH + t] = dgg;
      dg[3 * UH + t] = dgo;
      T* out = dgates_seq + ((size_t)k * B + row) * G + t;
      store(out, dgi);
      store(out + UH, dgf);
      store(out + 2 * UH, dgg);
      store(out + 3 * UH, dgo);
    }
    __syncthreads();
    if (owner) {
      // dz[t] = sum_j dgates[j] * W_eff^T[j, t]; four partial sums for ILP
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      const T* w_col = wt + t;
#pragma unroll 2
      for (int j = 0; j < G; j += 4) {
        a0 = fmaf(dg[j], load_f32(w_col + (size_t)j * UH), a0);
        a1 = fmaf(dg[j + 1], load_f32(w_col + (size_t)(j + 1) * UH), a1);
        a2 = fmaf(dg[j + 2], load_f32(w_col + (size_t)(j + 2) * UH), a2);
        a3 = fmaf(dg[j + 3], load_f32(w_col + (size_t)(j + 3) * UH), a3);
      }
      const float dz = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
      dh = round_to(valid ? dz : __fadd_rn(dz, dh_tot), dh0);
      dc = round_to(valid ? __fmul_rn(dct, fg) : dc, dh0);
    }
    // no second barrier: the next step writes the other half of dg_buf,
    // and this half is rewritten only after the next step's barrier
  }
  if (owner) {
    store(dh_fin + (size_t)row * UH + t, dh);
    store(dc_fin + (size_t)row * UH + t, dc);
  }
}

template <typename T>
int launch(const void* wt, const void* gates_seq, const void* c_seq,
           const void* c_prev_seq, const void* dy, const void* dh0,
           const void* dc0, const void* lvec, void* dgates_seq, void* dh_fin,
           void* dc_fin, int K, int B, int UH, int H, int S, void* stream) {
  const int threads = (UH + 31) / 32 * 32;
  const size_t smem = 2 * 4 * (size_t)UH * sizeof(float);  // <= 32 KB
  wavefront_bwd_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)wt, (const T*)gates_seq, (const T*)c_seq,
      (const T*)c_prev_seq, (const T*)dy, (const T*)dh0, (const T*)dc0,
      (const int*)lvec, (T*)dgates_seq, (T*)dh_fin, (T*)dc_fin, K, B, UH, H,
      S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_bwd_f32(const void* wt, const void* gates_seq,
                                 const void* c_seq, const void* c_prev_seq,
                                 const void* dy, const void* dh0,
                                 const void* dc0, const void* lvec,
                                 void* dgates_seq, void* dh_fin, void* dc_fin,
                                 int K, int B, int UH, int H, int S,
                                 void* stream) {
  return launch<float>(wt, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0, lvec,
                       dgates_seq, dh_fin, dc_fin, K, B, UH, H, S, stream);
}

extern "C" int wavefront_bwd_bf16(const void* wt, const void* gates_seq,
                                  const void* c_seq, const void* c_prev_seq,
                                  const void* dy, const void* dh0,
                                  const void* dc0, const void* lvec,
                                  void* dgates_seq, void* dh_fin,
                                  void* dc_fin, int K, int B, int UH, int H,
                                  int S, void* stream) {
  return launch<__nv_bfloat16>(wt, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                               lvec, dgates_seq, dh_fin, dc_fin, K, B, UH, H,
                               S, stream);
}
