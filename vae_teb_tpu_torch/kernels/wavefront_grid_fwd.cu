// Forward wavefront LSTM recurrence for Hopper (sm_90a), on one cooperative
// grid: the shapes the cluster kernel (wavefront_fwd.cu) does not take.
//
// Replaces, with wavefront_fwd.cu, the TPU kernel
// vae_teb_tpu/models/wavefront_pallas.py::_fwd_kernel (launched by
// wavefront_scan_pallas). It computes exactly what wavefront_fwd.cu
// computes, on the same inputs and outputs (see that file's header and
// kernels/wavefront_ref.py): K = S + D - 1 steps of
//
//   gates = h_cat @ W_eff + xs[k] + b          (fp32 accumulate)
//   c' = f * c + i * g,  h' = o * tanh(c')     (fp32 cell math)
//
// with unit u taking (h', c') only when lvec[u] <= k < S + lvec[u], and h,
// c (and, in the *_res_* entry points, the pre-activation gates and the
// carried c of every step) rounded to the storage type.
//
// Why a second design: the cluster kernel keeps a whole unit's 2H x 4H
// weights in one CTA and runs one CTA per unit in a cluster of at most 8.
// The forecast and predict-st decoders' LSTM(256, 3) and LSTM(256, 2) need
// 2 MB of fp32 weights a unit (and 1024 threads), wider encoders (H = 128)
// 512 KB, and 5-layer encoder pairs 10 units: none fits a CTA or a
// cluster. Here the units' columns are spread over the whole card.
//   - One cooperative launch (cudaLaunchCooperativeKernel) of U * H / N
//     CTAs, all resident at once (kernels/wavefront.py::_launch_plan asks
//     the card how many it holds and picks N from 8, 16, 32, the fewest
//     columns with which they fit). CTA (u, j) owns state columns t0 = j N
//     .. t0 + N - 1 of unit u and all four gate columns q H + t of each.
//   - It keeps its 2H x 4N slice of Wf[u] (recurrent rows, then feed rows)
//     in shared memory in the storage type for all K steps: 64 KB fp32 at
//     H = 256, N = 8. The wrapper hands the kernel Wf in wavefront_fwd.cu's
//     layout, which the kernel reads its slice out of.
//   - h_seq itself is the exchange buffer: step k reads the h of units u
//     and u-1 that step k-1 stored in h_seq[k-1] (h0 at k = 0) through L2,
//     in chunks of RB = 16 batch rows staged in shared memory in the
//     storage type by 16-byte cp.async copies (all of a chunk's in flight
//     at once; cp.async.cg reads L2, never a stale L1 line).
//     Each warp takes an interleaved slice of the depth (four rows of the
//     weight slice per 16-byte read of h), every lane one to four gate
//     columns for all RB rows; the 8 slices' partial sums meet in shared
//     memory, and the cell phase adds xs and b and runs the cell for the
//     chunk's RB x N cells. The carried c lives in c_fin (each cell read and
//     written by the same thread every step).
//   - One grid-wide barrier per step (a counter in global memory, release
//     fence before the arrival, acquire load in the wait): step k's h is in
//     h_seq before any CTA reads it for step k+1.
// What bounds it on the card: 2 * H * 4H fp32 FMAs per non-zero block, per
// row, per step a unit runs: 25.2 GFLOP at B = 32, S = 300, H = 256 with 5
// blocks (3 units), 0.376 ms at 67 TFLOP/s. This first design makes every
// CTA reread h of two units from L2 per step and waits at a grid barrier
// per step; making it fast is later work.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_grid.cuh"

namespace {

constexpr int RB = 16;  // batch rows a chunk

size_t smem_bytes(int N, int H, size_t item) {
  return (size_t)2 * H * 4 * N * item                 // weight slice [2H][4N]
         + (size_t)RB * (2 * H + 16 / item) * item     // h rows of a chunk
         + (size_t)WARPS * RB * 4 * N * 4;             // partial gates
}

template <typename T, int N, bool RESIDUALS>
__global__ void __launch_bounds__(THREADS, 1)
    wavefront_grid_fwd_kernel(const T* __restrict__ wf,
                              const T* __restrict__ b,
                              const T* __restrict__ xs,
                              const T* __restrict__ h0,
                              const T* __restrict__ c0,
                              const int* __restrict__ lvec, T* h_seq,
                              T* __restrict__ gates_seq,
                              T* __restrict__ c_seq, T* __restrict__ h_fin,
                              T* c_fin, unsigned* bar, int K, int B, int U,
                              int H, int S) {
  constexpr int C = 4 * N;    // gate columns of this CTA: q * N + c
  constexpr int CL = C / 32;  // of them, per lane
  const int u = blockIdx.x / (H / N);
  const int t0 = (blockIdx.x % (H / N)) * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int UH = U * H, G = 4 * UH;
  const int layer = lvec[u];
  const int D = layer > 0 ? 2 * H : H;  // depth: own h, then unit u-1's
  constexpr int V = 16 / sizeof(T);     // storage values a 16-byte copy
  const int HS = 2 * H + V;             // h row stride in shared memory

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);  // [2H][C]
  T* h_s = w_s + (size_t)2 * H * C;     // [RB][HS]
  float* part = reinterpret_cast<float*>(h_s + RB * HS);  // [WARPS][RB][C]

  // the slice of Wf[u], out of wavefront_fwd.cu's layout [U][2H/4][4][H][4]
  for (int i = tid; i < D * C; i += THREADS) {
    const int d = i / C, cc = i % C, q = cc / N, c = cc % N;
    w_s[i] = wf[((((size_t)u * (H / 2) + d / 4) * 4 + d % 4) * H + t0 + c) * 4 +
                q];
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const bool valid = layer <= k && k < S + layer;
    const T* h_prev = k ? h_seq + (size_t)(k - 1) * B * UH : h0;
    const T* c_prev = k ? c_fin : c0;
    const T* xk = xs + (size_t)k * B * G;
    for (int r0 = 0; r0 < B; r0 += RB) {
      // the chunk's h rows, V values a copy; rows past the batch are zeros
      for (int i = tid; i < RB * (D / V); i += THREADS) {
        const int m = i / (D / V), d = (i % (D / V)) * V, row = r0 + m;
        T* dst = h_s + m * HS + d;
        if (row < B)
          cp_async16(dst, h_prev + (size_t)row * UH +
                              (d < H ? u * H + d : (u - 1) * H + d - H));
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      // product: depth slice `warp` of [h_u | h_{u-1}] @ the weight slice
      float acc[RB][CL];
#pragma unroll
      for (int m = 0; m < RB; ++m)
#pragma unroll
        for (int j = 0; j < CL; ++j) acc[m][j] = 0.f;
      for (int d4 = warp; d4 < D / 4; d4 += WARPS) {
        float w[4][CL];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < CL; ++j)
            w[e][j] = load_f32(w_s + (4 * d4 + e) * C + lane + 32 * j);
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          const float4 hv = load4(h_s + m * HS + 4 * d4);
#pragma unroll
          for (int j = 0; j < CL; ++j)
            acc[m][j] = fmaf(hv.w, w[3][j],
                             fmaf(hv.z, w[2][j],
                                  fmaf(hv.y, w[1][j],
                                       fmaf(hv.x, w[0][j], acc[m][j]))));
        }
      }
#pragma unroll
      for (int m = 0; m < RB; ++m)
#pragma unroll
        for (int j = 0; j < CL; ++j)
          part[(warp * RB + m) * C + lane + 32 * j] = acc[m][j];
      __syncthreads();
      // cell phase: the chunk's RB x N cells
      for (int cell = tid; cell < RB * N; cell += THREADS) {
        const int m = cell / N, c = cell % N, row = r0 + m;
        if (row >= B) continue;
        const int col = u * H + t0 + c;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* p = part + m * C + q * N + c;
          float dot = p[0];
#pragma unroll
          for (int s = 1; s < WARPS; ++s) dot = __fadd_rn(dot, p[s * RB * C]);
          g[q] = __fadd_rn(
              __fadd_rn(dot, load_f32(xk + (size_t)row * G + q * UH + col)),
              load_f32(b + q * UH + col));
        }
        float hv = load_f32(h_s + m * HS + t0 + c);  // carried when idle
        float cv = load_cg(c_prev + (size_t)row * UH + col);
        if (valid) {
          const float ig = sigmoid(g[0]), fg = sigmoid(g[1]);
          const float gt = tanhf(g[2]), og = sigmoid(g[3]);
          const float c_new = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gt));
          const float h_new = __fmul_rn(og, tanhf(c_new));
          hv = round_to(h_new, h0);
          cv = round_to(c_new, h0);
        }
        const size_t off = ((size_t)k * B + row) * UH + col;
        store(h_seq + off, hv);
        store(c_fin + (size_t)row * UH + col, cv);
        if (RESIDUALS) {
          store(c_seq + off, cv);
          T* gp = gates_seq + ((size_t)k * B + row) * G + col;
#pragma unroll
          for (int q = 0; q < 4; ++q) store(gp + q * UH, g[q]);
        }
        if (k == K - 1) store(h_fin + (size_t)row * UH + col, hv);
      }
      __syncthreads();  // h_s and part are refilled by the next chunk
    }
    if (k + 1 < K) grid_barrier(bar, k + 1);  // h_seq[k] complete
  }
}

#define GRID_FWD_CASE(n) \
  case n:                \
    return (const void*)wavefront_grid_fwd_kernel<T, n, RESIDUALS>;

// the kernel for N state columns a CTA, N in {8, 16, 32}
template <typename T, bool RESIDUALS>
const void* kernel_for(int N) {
  switch (N) { GRID_FWD_CASE(8) GRID_FWD_CASE(16) GRID_FWD_CASE(32) }
  return nullptr;
}

template <typename T, bool RESIDUALS>
int launch(const void* w, const void* b, const void* xs, const void* h0,
           const void* c0, const void* lvec, void* h_seq, void* gates_seq,
           void* c_seq, void* h_fin, void* c_fin, void* bar, int K, int B,
           int U, int H, int S, int N, int smem, void* stream) {
  const void* kernel = kernel_for<T, RESIDUALS>(N);
  if (kernel == nullptr || H % N || H % 8 ||
      (size_t)smem != smem_bytes(N, H, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&w,     &b,     &xs,   &h0,  &c0, &lvec, &h_seq,
                  &gates_seq, &c_seq, &h_fin, &c_fin, &bar, &K, &B,
                  &U,     &H,     &S};
  return launch_grid(kernel, U * H / N, smem, args, stream);
}

}  // namespace

extern "C" int wavefront_grid_fwd_f32(const void* w, const void* b,
                                      const void* xs, const void* h0,
                                      const void* c0, const void* lvec,
                                      void* h_seq, void* h_fin, void* c_fin,
                                      void* bar, int K, int B, int U, int H,
                                      int S, int N, int smem, void* stream) {
  return launch<float, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr, nullptr,
                              h_fin, c_fin, bar, K, B, U, H, S, N, smem,
                              stream);
}

extern "C" int wavefront_grid_fwd_bf16(const void* w, const void* b,
                                       const void* xs, const void* h0,
                                       const void* c0, const void* lvec,
                                       void* h_seq, void* h_fin, void* c_fin,
                                       void* bar, int K, int B, int U, int H,
                                       int S, int N, int smem, void* stream) {
  return launch<__nv_bfloat16, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr,
                                      nullptr, h_fin, c_fin, bar, K, B, U, H,
                                      S, N, smem, stream);
}

extern "C" int wavefront_grid_fwd_res_f32(
    const void* w, const void* b, const void* xs, const void* h0,
    const void* c0, const void* lvec, void* h_seq, void* gates_seq,
    void* c_seq, void* h_fin, void* c_fin, void* bar, int K, int B, int U,
    int H, int S, int N, int smem, void* stream) {
  return launch<float, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq, c_seq,
                             h_fin, c_fin, bar, K, B, U, H, S, N, smem,
                             stream);
}

extern "C" int wavefront_grid_fwd_res_bf16(
    const void* w, const void* b, const void* xs, const void* h0,
    const void* c0, const void* lvec, void* h_seq, void* gates_seq,
    void* c_seq, void* h_fin, void* c_fin, void* bar, int K, int B, int U,
    int H, int S, int N, int smem, void* stream) {
  return launch<__nv_bfloat16, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq,
                                     c_seq, h_fin, c_fin, bar, K, B, U, H, S,
                                     N, smem, stream);
}

// How many CTAs of the residual forward for N columns the card holds at
// once, or minus the CUDA error. The serving variant has the same shape
// and shared memory.
extern "C" int wavefront_grid_fwd_max_ctas(int bf16, int N, int smem) {
  return max_ctas(bf16 ? kernel_for<__nv_bfloat16, true>(N)
                       : kernel_for<float, true>(N),
                  smem);
}
