// Forward wavefront LSTM recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel vae_teb_tpu/models/wavefront_pallas.py::_fwd_kernel
// (launched by wavefront_scan_pallas). U LSTM units (every layer of every
// stream) run as one staircase recurrence of K = S + D - 1 steps. At step k:
//
//   gates = h_cat @ W_eff + xs[k] + b          (fp32 accumulate)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c' = f * c + i * g,  h' = o * tanh(c')
//
// and unit u (layer lvec[u]) takes (h', c') only when lvec[u] <= k < S +
// lvec[u]; otherwise it carries its state. W_eff (UH, 4UH) is gate-major:
// gate q of state column t sits in column q * UH + t.
//
// Rounding points follow the TPU kernel: h and W are read in the storage
// type (fp32 or bf16), products are summed in fp32, xs and b are added in
// fp32, the cell math is fp32, and h and c are rounded to the storage type
// after every step. kernels/wavefront_ref.py is the same computation in
// plain PyTorch.
//
// Design (simple first version). The recurrence is independent across the
// batch, so one block owns one batch row for all K steps and no grid-wide
// synchronisation is needed. Thread t owns state column t: it keeps c in a
// register and forms its four gate dot products of length UH against W_eff
// columns q * UH + t, so a warp reads 32 neighbouring columns of one W row
// (coalesced). h lives in shared memory, double-buffered, so each step needs
// one __syncthreads. What bounds it on the card: every block streams all of
// W_eff (4 MB in fp32 at UH = 512) from L2 once per step, so the time is
// roughly K * |W_eff| / (one SM's L2 bandwidth), independent of B while B
// stays under the SM count. Keeping W_eff slices resident in shared memory
// across a cluster, and skipping its zero blocks, are later work.
//
// Training needs the residuals the backward reads (wavefront_bwd.cu): the
// entry points *_res_* also store the pre-activation gates of every step,
// rounded to the storage type (thread t writes gates_seq[k, row, q*UH + t],
// so a warp's stores are coalesced), and the carried c after every step.
// The serving entry points compile without those stores.
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

template <typename T, bool RESIDUALS>
__global__ void wavefront_fwd_kernel(const T* __restrict__ w,
                                     const T* __restrict__ b,
                                     const T* __restrict__ xs,
                                     const T* __restrict__ h0,
                                     const T* __restrict__ c0,
                                     const int* __restrict__ lvec,
                                     T* __restrict__ h_seq,
                                     T* __restrict__ gates_seq,
                                     T* __restrict__ c_seq,
                                     T* __restrict__ h_fin,
                                     T* __restrict__ c_fin,
                                     int K, int B, int UH, int H, int S) {
  extern __shared__ float h_buf[];  // 2 * UH floats: h of step k, h of k+1
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int G = 4 * UH;
  const bool owner = t < UH;

  float h = 0.f, c = 0.f, b_i = 0.f, b_f = 0.f, b_g = 0.f, b_o = 0.f;
  int layer = 0;
  if (owner) {
    h = load_f32(h0 + (size_t)row * UH + t);
    c = load_f32(c0 + (size_t)row * UH + t);
    b_i = load_f32(b + t);
    b_f = load_f32(b + UH + t);
    b_g = load_f32(b + 2 * UH + t);
    b_o = load_f32(b + 3 * UH + t);
    layer = lvec[t / H];
    h_buf[t] = h;
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float* h_cur = h_buf + (k & 1) * UH;
    float* h_next = h_buf + ((k + 1) & 1) * UH;
    if (owner) {
      float acc_i = 0.f, acc_f = 0.f, acc_g = 0.f, acc_o = 0.f;
      const T* w_col = w + t;
#pragma unroll 4
      for (int j = 0; j < UH; ++j) {
        const float hj = h_cur[j];
        const T* w_row = w_col + (size_t)j * G;
        acc_i = fmaf(hj, load_f32(w_row), acc_i);
        acc_f = fmaf(hj, load_f32(w_row + UH), acc_f);
        acc_g = fmaf(hj, load_f32(w_row + 2 * UH), acc_g);
        acc_o = fmaf(hj, load_f32(w_row + 3 * UH), acc_o);
      }
      const T* x = xs + ((size_t)k * B + row) * G + t;
      const float gi = __fadd_rn(__fadd_rn(acc_i, load_f32(x)), b_i);
      const float gf = __fadd_rn(__fadd_rn(acc_f, load_f32(x + UH)), b_f);
      const float gg = __fadd_rn(__fadd_rn(acc_g, load_f32(x + 2 * UH)), b_g);
      const float go = __fadd_rn(__fadd_rn(acc_o, load_f32(x + 3 * UH)), b_o);
      const float ig = sigmoid(gi), fg = sigmoid(gf);
      const float gt = tanhf(gg), og = sigmoid(go);
      const float c_new = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gt));
      const float h_new = __fmul_rn(og, tanhf(c_new));
      if (layer <= k && k < S + layer) {
        h = round_to(h_new, h0);
        c = round_to(c_new, h0);
      }
      h_next[t] = h;
      store(h_seq + ((size_t)k * B + row) * UH + t, h);
      if (RESIDUALS) {
        T* gk = gates_seq + ((size_t)k * B + row) * G + t;
        store(gk, gi);
        store(gk + UH, gf);
        store(gk + 2 * UH, gg);
        store(gk + 3 * UH, go);
        store(c_seq + ((size_t)k * B + row) * UH + t, c);
      }
    }
    __syncthreads();
  }
  if (owner) {
    store(h_fin + (size_t)row * UH + t, h);
    store(c_fin + (size_t)row * UH + t, c);
  }
}

template <typename T, bool RESIDUALS>
int launch(const void* w, const void* b, const void* xs, const void* h0,
           const void* c0, const void* lvec, void* h_seq, void* gates_seq,
           void* c_seq, void* h_fin, void* c_fin, int K, int B, int UH, int H,
           int S, void* stream) {
  const int threads = (UH + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)UH * sizeof(float);
  wavefront_fwd_kernel<T, RESIDUALS><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)w, (const T*)b, (const T*)xs, (const T*)h0, (const T*)c0,
      (const int*)lvec, (T*)h_seq, (T*)gates_seq, (T*)c_seq, (T*)h_fin,
      (T*)c_fin, K, B, UH, H, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_fwd_f32(const void* w, const void* b, const void* xs,
                                 const void* h0, const void* c0,
                                 const void* lvec, void* h_seq, void* h_fin,
                                 void* c_fin, int K, int B, int UH, int H,
                                 int S, void* stream) {
  return launch<float, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr, nullptr,
                              h_fin, c_fin, K, B, UH, H, S, stream);
}

extern "C" int wavefront_fwd_bf16(const void* w, const void* b,
                                  const void* xs, const void* h0,
                                  const void* c0, const void* lvec,
                                  void* h_seq, void* h_fin, void* c_fin, int K,
                                  int B, int UH, int H, int S, void* stream) {
  return launch<__nv_bfloat16, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr,
                                      nullptr, h_fin, c_fin, K, B, UH, H, S,
                                      stream);
}

extern "C" int wavefront_fwd_res_f32(const void* w, const void* b,
                                     const void* xs, const void* h0,
                                     const void* c0, const void* lvec,
                                     void* h_seq, void* gates_seq, void* c_seq,
                                     void* h_fin, void* c_fin, int K, int B,
                                     int UH, int H, int S, void* stream) {
  return launch<float, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq, c_seq,
                             h_fin, c_fin, K, B, UH, H, S, stream);
}

extern "C" int wavefront_fwd_res_bf16(const void* w, const void* b,
                                      const void* xs, const void* h0,
                                      const void* c0, const void* lvec,
                                      void* h_seq, void* gates_seq,
                                      void* c_seq, void* h_fin, void* c_fin,
                                      int K, int B, int UH, int H, int S,
                                      void* stream) {
  return launch<__nv_bfloat16, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq,
                                     c_seq, h_fin, c_fin, K, B, UH, H, S,
                                     stream);
}
