// Reverse wavefront LSTM recurrence for Hopper (sm_90a), on one cooperative
// grid: the shapes the cluster kernel (wavefront_bwd.cu) does not take.
//
// Replaces, with wavefront_bwd.cu, the TPU kernel
// vae_teb_tpu/models/wavefront_pallas.py::_bwd_kernel (launched by
// wavefront_bwd_pallas). It computes exactly what wavefront_bwd.cu
// computes, on the same inputs and outputs (see that file's header and
// kernels/wavefront_ref.py::wavefront_bwd_plain): per reverse step k the
// dgates of every cell from the stored gates and c, the carried (dh, dc)
// and dY[k], zero for idle units; dz = dgates @ W_eff^T; dh' = dz (+ dh_tot
// for idle units), dc' = dct * f (dc for idle units), with dh, dc and the
// dgates rounded to the storage type.
//
// Design, on the skeleton of wavefront_grid_fwd.cu: one cooperative grid of
// U * H / N CTAs, CTA (u, j) owning state columns t0 = j N .. t0 + N - 1 of
// unit u.
//   - It keeps the W_eff^T rows that produce dh for its columns in shared
//     memory for all K steps: unit u's recurrent block and unit u+1's feed
//     block, [8H][N] in the storage type (64 KB fp32 at H = 256, N = 8),
//     read out of the wrapper's Wb layout [U][8H][H] (wavefront_bwd.cu's).
//   - Step k, cell phase: the CTA's B x N cells read the carried dh, dc
//     (dh0, dc0 at k = K-1; then dh_fin, dc_fin, which hold the carried
//     state, each cell read and written by one thread), dY[k] and the
//     stored gates and c; they write their four dgates to dgates_seq[k] and
//     the new dc.
//   - One grid-wide barrier: dgates_seq[k] is the exchange buffer.
//   - Product phase: the dgates of units u and u+1 at step k (8H a row, 4H
//     when unit u+1 is not fed by u) are staged in shared memory through L2
//     in chunks of RB = 8 rows, in the storage type, by 16-byte cp.async
//     copies all in flight at once; each warp takes an interleaved slice
//     of the depth, every lane one column of 32 / N rows; the 8 slices'
//     partial sums meet in shared memory and dh' is formed and stored.
// What bounds it on the card: 2 * H * 4H fp32 FMAs per non-zero block, per
// row, per step a unit runs, as the forward (0.376 ms at B = 32, S = 300,
// H = 256, 3 units). One barrier per step, and every CTA rereads two
// units' dgates from L2 per step.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_grid.cuh"

namespace {

constexpr int RB = 8;  // batch rows a chunk of the product

size_t smem_bytes(int N, int H, size_t item) {
  return (size_t)8 * H * N * item                  // W_eff^T rows [8H][N]
         + (size_t)RB * (8 * H + 16 / item) * item  // dgates rows of a chunk
         + (size_t)WARPS * RB * N * 4;              // partial dz of 8 slices
}

// x * y * (1 - y), evaluated left to right without contraction
__device__ __forceinline__ float mul_dsig(float x, float y) {
  return __fmul_rn(__fmul_rn(x, y), __fsub_rn(1.0f, y));
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1)
    wavefront_grid_bwd_kernel(const T* __restrict__ wb,
                              const T* __restrict__ gates_seq,
                              const T* __restrict__ c_seq,
                              const T* __restrict__ c_prev_seq,
                              const T* __restrict__ dy,
                              const T* __restrict__ dh0,
                              const T* __restrict__ dc0,
                              const int* __restrict__ lvec, T* dgates_seq,
                              T* dh_fin, T* dc_fin, unsigned* bar, int K,
                              int B, int U, int H, int S) {
  constexpr int GR = 32 / N;   // row groups of a warp
  constexpr int RL = RB / GR;  // rows a lane
  const int u = blockIdx.x / (H / N);
  const int t0 = (blockIdx.x % (H / N)) * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / N, cl = lane % N;
  const int UH = U * H, G = 4 * UH;
  const int layer = lvec[u];
  const bool feed_out = u + 1 < U && lvec[u + 1] > 0;
  const int D = feed_out ? 8 * H : 4 * H;  // own gates, then unit u+1's
  constexpr int V = 16 / sizeof(T);        // storage values a 16-byte copy
  const int DS = 8 * H + V;                // dgates row stride

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);  // [8H][N]
  T* d_s = w_s + (size_t)8 * H * N;     // [RB][DS]
  float* part = reinterpret_cast<float*>(d_s + RB * DS);  // [WARPS][RB][N]

  for (int i = tid; i < D * N; i += THREADS) {
    const int j = i / N, c = i % N;
    w_s[i] = wb[((size_t)u * 8 * H + j) * H + t0 + c];
  }
  __syncthreads();

  for (int k = K - 1; k >= 0; --k) {
    const bool valid = layer <= k && k < S + layer;
    const T* dh_src = k == K - 1 ? dh0 : dh_fin;
    const T* dc_src = k == K - 1 ? dc0 : dc_fin;
    const size_t kb = (size_t)k * B;
    // cell phase: this CTA's dgates of step k and the carried dc
    for (int cell = tid; cell < B * N; cell += THREADS) {
      const int row = cell / N, col = u * H + t0 + cell % N;
      const size_t off = (kb + row) * UH + col, goff = (kb + row) * G + col;
      const float dh_tot =
          __fadd_rn(load_cg(dh_src + (size_t)row * UH + col), load_f32(dy + off));
      const float dc = load_cg(dc_src + (size_t)row * UH + col);
      const float ig = sigmoid(load_f32(gates_seq + goff));
      const float fg = sigmoid(load_f32(gates_seq + goff + UH));
      const float gt = tanhf(load_f32(gates_seq + goff + 2 * UH));
      const float og = sigmoid(load_f32(gates_seq + goff + 3 * UH));
      const float tc = tanhf(load_f32(c_seq + off));
      const float cprev = load_f32(c_prev_seq + off);
      const float d_o = __fmul_rn(dh_tot, tc);
      const float dct = __fadd_rn(
          dc, __fmul_rn(__fmul_rn(dh_tot, og),
                        __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid) {
        dg[0] = mul_dsig(__fmul_rn(dct, gt), ig);
        dg[1] = mul_dsig(__fmul_rn(dct, cprev), fg);
        dg[2] = __fmul_rn(__fmul_rn(dct, ig), __fsub_rn(1.0f, __fmul_rn(gt, gt)));
        dg[3] = mul_dsig(d_o, og);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) store(dgates_seq + goff + q * UH, dg[q]);
      store(dc_fin + (size_t)row * UH + col, valid ? __fmul_rn(dct, fg) : dc);
    }
    grid_barrier(bar, K - k);  // dgates_seq[k] complete
    // product phase: dz = [dg_u | dg_{u+1}] @ W_eff^T rows, then dh
    for (int r0 = 0; r0 < B; r0 += RB) {
      // the chunk's dgates rows, V values a copy: segment (unit, q) of H
      // values each; rows past the batch are zeros
      for (int i = tid; i < RB * (D / V); i += THREADS) {
        const int m = i / (D / V), j = (i % (D / V)) * V, row = r0 + m;
        T* dst = d_s + m * DS + j;
        if (row < B) {
          const int unit = u + j / (4 * H), q = (j / H) % 4, t = j % H;
          cp_async16(dst, dgates_seq + (kb + row) * G + q * UH + unit * H + t);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float acc[RL];
#pragma unroll
      for (int r = 0; r < RL; ++r) acc[r] = 0.f;
      for (int d4 = warp; d4 < D / 4; d4 += WARPS) {
        const float w0 = load_f32(w_s + (4 * d4) * N + cl);
        const float w1 = load_f32(w_s + (4 * d4 + 1) * N + cl);
        const float w2 = load_f32(w_s + (4 * d4 + 2) * N + cl);
        const float w3 = load_f32(w_s + (4 * d4 + 3) * N + cl);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const float4 dv = load4(d_s + (rg + GR * r) * DS + 4 * d4);
          acc[r] = fmaf(dv.w, w3, fmaf(dv.z, w2, fmaf(dv.y, w1,
                                                      fmaf(dv.x, w0, acc[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < RL; ++r)
        part[(warp * RB + rg + GR * r) * N + cl] = acc[r];
      __syncthreads();
      for (int cell = tid; cell < RB * N; cell += THREADS) {
        const int m = cell / N, row = r0 + m;
        if (row >= B) continue;
        const int col = u * H + t0 + cell % N;
        const float* p = part + cell;
        float dz = p[0];
#pragma unroll
        for (int s = 1; s < WARPS; ++s) dz = __fadd_rn(dz, p[s * RB * N]);
        if (!valid)  // an idle unit carries dh_tot through
          dz = __fadd_rn(dz, __fadd_rn(load_cg(dh_src + (size_t)row * UH + col),
                                       load_f32(dy + (kb + row) * UH + col)));
        store(dh_fin + (size_t)row * UH + col, dz);
      }
      __syncthreads();  // d_s and part are refilled by the next chunk
    }
  }
}

#define GRID_BWD_CASE(n) \
  case n:                \
    return (const void*)wavefront_grid_bwd_kernel<T, n>;

// the kernel for N state columns a CTA, N in {8, 16, 32}
template <typename T>
const void* kernel_for(int N) {
  switch (N) { GRID_BWD_CASE(8) GRID_BWD_CASE(16) GRID_BWD_CASE(32) }
  return nullptr;
}

template <typename T>
int launch(const void* wb, const void* gates_seq, const void* c_seq,
           const void* c_prev_seq, const void* dy, const void* dh0,
           const void* dc0, const void* lvec, void* dgates_seq, void* dh_fin,
           void* dc_fin, void* bar, int K, int B, int U, int H, int S, int N,
           int smem, void* stream) {
  const void* kernel = kernel_for<T>(N);
  if (kernel == nullptr || H % N || H % 8 ||
      (size_t)smem != smem_bytes(N, H, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&wb,  &gates_seq,  &c_seq,  &c_prev_seq, &dy,
                  &dh0, &dc0,        &lvec,   &dgates_seq, &dh_fin,
                  &dc_fin, &bar,     &K,      &B,          &U,
                  &H,   &S};
  return launch_grid(kernel, U * H / N, smem, args, stream);
}

}  // namespace

extern "C" int wavefront_grid_bwd_f32(const void* wb, const void* gates_seq,
                                      const void* c_seq,
                                      const void* c_prev_seq, const void* dy,
                                      const void* dh0, const void* dc0,
                                      const void* lvec, void* dgates_seq,
                                      void* dh_fin, void* dc_fin, void* bar,
                                      int K, int B, int U, int H, int S,
                                      int N, int smem, void* stream) {
  return launch<float>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0, lvec,
                       dgates_seq, dh_fin, dc_fin, bar, K, B, U, H, S, N,
                       smem, stream);
}

extern "C" int wavefront_grid_bwd_bf16(const void* wb, const void* gates_seq,
                                       const void* c_seq,
                                       const void* c_prev_seq, const void* dy,
                                       const void* dh0, const void* dc0,
                                       const void* lvec, void* dgates_seq,
                                       void* dh_fin, void* dc_fin, void* bar,
                                       int K, int B, int U, int H, int S,
                                       int N, int smem, void* stream) {
  return launch<__nv_bfloat16>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                               lvec, dgates_seq, dh_fin, dc_fin, bar, K, B, U,
                               H, S, N, smem, stream);
}

// How many CTAs of the reverse wavefront for N columns the card holds at
// once, or minus the CUDA error.
extern "C" int wavefront_grid_bwd_max_ctas(int bf16, int N, int smem) {
  return max_ctas(bf16 ? kernel_for<__nv_bfloat16>(N) : kernel_for<float>(N),
                  smem);
}
