// Forward wavefront LSTM recurrence for Hopper (sm_90a), on thread-block
// clusters.
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
// lvec[u]; otherwise it carries its state. W_eff (UH, 4UH) is gate-major
// (gate q of state column t sits in column q * UH + t) and block-bidiagonal
// as models/blocks.py::_wavefront_pack makes it: unit u's gates read only
// its own h (recurrent block) and, when lvec[u] > 0, the h of unit u-1
// (feed block). The wrapper (kernels/wavefront.py) hands the kernel those
// blocks only, per unit Wf[u] (2H, 4H): the recurrent block, then the feed
// block or zeros.
//
// Rounding points follow the TPU kernel: h and W are read in the storage
// type (fp32 or bf16), products are summed in fp32, xs and b are added in
// fp32, the cell math is fp32, and h and c are rounded to the storage type
// after every step. kernels/wavefront_ref.py is the same computation in
// plain PyTorch (on the dense W_eff).
//
// What bounds it on the card: the work is 2 * H * 4H fp32 FMAs per non-zero
// block, per row, per step: 4.45 GFLOP at B=32, K=303, H=64 with 14 blocks,
// 66 us at 67 TFLOP/s (the bytes, ~100 MB, take 30 us). In practice the
// 303-step dependency chain sets the floor: each step rereads the unit's
// weights from shared memory, runs the cell math and waits for the
// neighbour's h.
//
// The first design (one block per batch row) used 32 of 132 SMs at B=32 and
// streamed all of W_eff (4 MB fp32, 78% zero blocks) from L2 on every step,
// 27 ms per call. This design: one thread-block cluster of U CTAs per group
// of M batch rows, CTA u owning unit u.
//   - CTA u loads Wf[u] (128 KB fp32, 64 KB bf16 at H = 64) into shared
//     memory once and keeps it for all K steps; no global weight traffic.
//     The wrapper forms Wf in this kernel's layout with one gather per call.
//   - Product phase: thread (ks, t) = threadIdx.x = ks * H + t forms the
//     four gates of state column t for all M rows over depth slice ks
//     (depths 4 d4 .. 4 d4 + 3 for d4 = ks, ks + 4, ...). Each 16-byte
//     weight load brings the four gates of one depth, so one broadcast read
//     of h serves four columns: per step a CTA reads its weights once and h
//     (M x 2H) once per warp. (With one gate column per thread, every column
//     reread h, at four shared-memory wavefronts per 16-byte broadcast, and
//     that cost grew with M.) Wf[u] sits in shared memory as
//     [2H/4][4][H][4] (d4, depth%4, t, gate), so a warp's weight loads cover
//     512 contiguous bytes.
//   - The four slices' partial sums meet in shared memory; after one CTA
//     barrier, thread (ks, t) sums them for rows m = ks, ks + 4, ..., adds
//     xs and b and runs the cell math (c stays in its registers).
//   - h is double-buffered in shared memory as [2][M][own H | unit u-1's
//     H]. CTA u writes its new h into its own buffer and, when
//     lvec[u+1] > 0, into CTA u+1's with st.async (distributed shared
//     memory), whose bytes an mbarrier in CTA u+1 counts: CTA u+1 waits
//     on that mbarrier, not on a release fence (a release/acquire cluster
//     barrier per step costs a large share of a step). A relaxed cluster
//     barrier per step (arrive after the product, wait at the end of the
//     step) keeps a CTA from refilling a neighbour's buffer before the
//     neighbour has read it.
//   - xs[k+1] rows are prefetched into shared memory with cp.async while
//     step k computes.
//   M is chosen by kernels/wavefront.py::_launch_plan so that all clusters
//   are resident at once (asked of the card with
//   cudaOccupancyMaxActiveClusters: the H100 holds 15 clusters of 8 CTAs,
//   one CTA per SM), so M = 3 at B = 32 and 9 at B = 128. Every CTA asks
//   for at least half an SM's shared memory, so that two never share one.
//
// Training needs the residuals the backward reads (wavefront_bwd.cu): the
// entry points *_res_* also store the pre-activation gates of every step,
// rounded to the storage type, and the carried c after every step. The
// serving entry points compile without those stores (template flag); both
// share one code path otherwise.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_common.cuh"

namespace {

size_t smem_bytes(int M, int H, size_t item) {
  return 16                               // two mbarriers
         + (size_t)8 * H * H * item       // Wf[u]
         + (size_t)2 * M * 2 * H * 4      // h, double-buffered
         + (size_t)2 * M * 4 * H * item   // xs rows, double-buffered
         + (size_t)16 * M * H * 4;        // partial gates of the 4 slices
}

// 4H <= 256 threads (the wrapper's planner refuses more), so a thread may
// hold up to 255 registers
template <typename T, int M, bool RESIDUALS>
__global__ void __launch_bounds__(256, 1)
    wavefront_fwd_kernel(const T* __restrict__ wf, const T* __restrict__ b,
                         const T* __restrict__ xs, const T* __restrict__ h0,
                         const T* __restrict__ c0,
                         const int* __restrict__ lvec, T* __restrict__ h_seq,
                         T* __restrict__ gates_seq, T* __restrict__ c_seq,
                         T* __restrict__ h_fin, T* __restrict__ c_fin, int K,
                         int B, int U, int H, int S) {
  constexpr int R = (M + 3) / 4;  // rows m = ks + 4r whose cell this thread owns
  constexpr int V = 16 / sizeof(T);         // storage values per 16-byte copy
  constexpr int J = (M * 4 + 4 * V - 1) / (4 * V);  // copies per thread per step
  cg::cluster_group cluster = cg::this_cluster();
  const int u = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * M;
  const int tid = threadIdx.x;
  const int ks = tid / H, t = tid % H;  // depth slice (and row phase), column
  const int UH = U * H, G = 4 * UH;
  const int layer = lvec[u];
  const bool feed_in = layer > 0;   // unit u-1 feeds unit u
  const bool feed_out = u + 1 < U && lvec[u + 1] > 0;
  const int depth4 = (feed_in ? 2 * H : H) / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  T* w_s = reinterpret_cast<T*>(smem + 16);
  float* h_s = reinterpret_cast<float*>(smem + 16 + (size_t)8 * H * H * sizeof(T));
  T* x_s = reinterpret_cast<T*>(h_s + 2 * M * 2 * H);
  float* part = reinterpret_cast<float*>(x_s + 2 * M * 4 * H);  // [4][M][4][H]
  // unit u+1's h buffers and mbarriers, as cluster addresses
  const unsigned h_succ = cluster_addr(smem_addr(h_s), u + 1 < U ? u + 1 : u);
  const unsigned full_succ = cluster_addr(smem_addr(full), u + 1 < U ? u + 1 : u);

  if (tid == 0) {  // full[b]: unit u-1's h has landed in h buffer b
    mbar_init(smem_addr(full));
    mbar_init(smem_addr(full + 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (feed_in) {
      mbar_expect(smem_addr(full), M * H * 4);
      mbar_expect(smem_addr(full + 1), M * H * 4);
    }
  }
  {  // Wf[u] stays resident for all K steps
    const uint4* src =
        reinterpret_cast<const uint4*>(wf + (size_t)u * 8 * H * H);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n = (int)((size_t)8 * H * H * sizeof(T) / 16);
    for (int i = tid; i < n; i += blockDim.x) dst[i] = src[i];
  }
  for (int i = tid; i < M * 2 * H; i += blockDim.x) {
    const int m = i / (2 * H), j = i % (2 * H);
    const size_t row = (size_t)min(row0 + m, B - 1) * UH;
    float v = 0.f;
    if (j < H)
      v = load_f32(h0 + row + u * H + j);
    else if (feed_in)
      v = load_f32(h0 + row + (u - 1) * H + (j - H));
    h_s[m * 2 * H + j] = v;
  }
  float h[R], c[R], gates[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t off = (size_t)min(row0 + ks + 4 * r, B - 1) * UH + u * H + t;
    h[r] = load_f32(h0 + off);
    c[r] = load_f32(c0 + off);
  }
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = load_f32(b + q * UH + u * H + t);
  // this thread's 16-byte copies of a step's xs rows: source offset within
  // xs[k] and destination within an xs buffer; rows past the batch read the
  // last row (their results are never stored)
  int src_off[J], dst_off[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = tid + j * blockDim.x, per_seg = H / V;
    const int c = i % per_seg, q = (i / per_seg) % 4, m = i / (4 * per_seg);
    const int row = min(row0 + m, B - 1);
    src_off[j] = i < M * 4 * per_seg ? row * G + q * UH + u * H + c * V : -1;
    dst_off[j] = (m * 4 + q) * H + c * V;
  }
  auto prefetch_xs = [&](int k, T* dst) {
    const T* src = xs + (size_t)k * B * G;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (src_off[j] >= 0) cp_async16(dst + dst_off[j], src + src_off[j]);
    cp_async_commit();
  };
  prefetch_xs(0, x_s);
  cp_async_wait_all();
  cluster_sync_full();  // every CTA runs, its mbarriers and h0 are in place

  unsigned parity[2] = {0u, 0u};
  for (int k = 0; k < K; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    if (feed_in && k > 0) {  // unit u-1's h of step k-1 has landed
      mbar_wait(smem_addr(full + cur), parity[cur]);
      parity[cur] ^= 1u;
      if (tid == 0) mbar_expect(smem_addr(full + cur), M * H * 4);  // step k+1
    }
    if (k + 1 < K) prefetch_xs(k + 1, x_s + nxt * M * 4 * H);
    // product phase: slice ks of [h_u | h_{u-1}] @ Wf[u] for column t
    const float* hb = h_s + cur * M * 2 * H;
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll 2
    for (int d4 = ks; d4 < depth4; d4 += 4) {
      const T* wp = w_s + ((size_t)d4 * 4 * H + t) * 4;
      const float4 w0 = load4(wp), w1 = load4(wp + 4 * H);
      const float4 w2 = load4(wp + 8 * H), w3 = load4(wp + 12 * H);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + m * 2 * H + 4 * d4);
        acc[m][0] = fmaf(hv.w, w3.x, fmaf(hv.z, w2.x, fmaf(hv.y, w1.x, fmaf(hv.x, w0.x, acc[m][0]))));
        acc[m][1] = fmaf(hv.w, w3.y, fmaf(hv.z, w2.y, fmaf(hv.y, w1.y, fmaf(hv.x, w0.y, acc[m][1]))));
        acc[m][2] = fmaf(hv.w, w3.z, fmaf(hv.z, w2.z, fmaf(hv.y, w1.z, fmaf(hv.x, w0.z, acc[m][2]))));
        acc[m][3] = fmaf(hv.w, w3.w, fmaf(hv.z, w2.w, fmaf(hv.y, w1.w, fmaf(hv.x, w0.w, acc[m][3]))));
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[((ks * M + m) * 4 + q) * H + t] = acc[m][q];
    // this CTA is done with h buffer cur: unit u-1 may refill it next step
    cluster_arrive_relaxed();
    __syncthreads();
    // cell phase: rows m = ks + 4r of column t (rows past M recompute row
    // M-1 and store nothing, so the R rows' math interleaves)
    const bool valid = layer <= k && k < S + layer;
    const T* xb = x_s + cur * M * 4 * H;
    const int sl = M * 4 * H;  // one slice's partials
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = min(ks + 4 * r, M - 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* p = part + (m * 4 + q) * H + t;
        const float dot = __fadd_rn(__fadd_rn(p[0], p[sl]),
                                    __fadd_rn(p[2 * sl], p[3 * sl]));
        gates[r][q] = __fadd_rn(
            __fadd_rn(dot, load_f32(xb + (m * 4 + q) * H + t)), bias[q]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ig = sigmoid(gates[r][0]), fg = sigmoid(gates[r][1]);
      const float gt = tanhf(gates[r][2]), og = sigmoid(gates[r][3]);
      const float c_new = __fadd_rn(__fmul_rn(fg, c[r]), __fmul_rn(ig, gt));
      const float h_new = __fmul_rn(og, tanhf(c_new));
      if (valid) {
        h[r] = round_to(h_new, h0);
        c[r] = round_to(c_new, h0);
      }
    }
    float* hn = h_s + nxt * M * 2 * H;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = ks + 4 * r;
      if (m < M) {
        hn[m * 2 * H + t] = h[r];
        if (feed_out)  // unit u+1 finished reading this buffer last step
          st_async(h_succ + ((nxt * M + m) * 2 * H + H + t) * 4, h[r],
                   full_succ + nxt * 8);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {  // global stores
      const int row = row0 + ks + 4 * r;
      if (ks + 4 * r < M && row < B) {
        const size_t off = ((size_t)k * B + row) * UH + u * H + t;
        store(h_seq + off, h[r]);
        if (RESIDUALS) {
          store(c_seq + off, c[r]);
          T* g = gates_seq + ((size_t)k * B + row) * G + u * H + t;
#pragma unroll
          for (int q = 0; q < 4; ++q) store(g + q * UH, gates[r][q]);
        }
      }
    }
    cp_async_wait_all();  // xs[k+1] landed (this thread's copies)
    cluster_wait();       // every CTA is done with its h buffer cur
    __syncthreads();      // own h of step k and xs[k+1] visible to the CTA
  }
  // unit u-1's last h (step K-1) lands before this CTA may exit
  if (feed_in) mbar_wait(smem_addr(full + (K & 1)), parity[K & 1]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + ks + 4 * r;
    if (ks + 4 * r < M && row < B) {
      store(h_fin + (size_t)row * UH + u * H + t, h[r]);
      store(c_fin + (size_t)row * UH + u * H + t, c[r]);
    }
  }
}

#define WAVEFRONT_FWD_CASE(m) \
  case m:                       \
    return (const void*)wavefront_fwd_kernel<T, m, RESIDUALS>;

// the kernel for M rows per cluster, 1 <= M <= 10
template <typename T, bool RESIDUALS>
const void* kernel_for(int M) {
  switch (M) {
    WAVEFRONT_FWD_CASE(1) WAVEFRONT_FWD_CASE(2) WAVEFRONT_FWD_CASE(3)
    WAVEFRONT_FWD_CASE(4) WAVEFRONT_FWD_CASE(5) WAVEFRONT_FWD_CASE(6)
    WAVEFRONT_FWD_CASE(7) WAVEFRONT_FWD_CASE(8) WAVEFRONT_FWD_CASE(9)
    WAVEFRONT_FWD_CASE(10)
  }
  return nullptr;
}

template <typename T, bool RESIDUALS>
int launch(const void* w, const void* b, const void* xs, const void* h0,
           const void* c0, const void* lvec, void* h_seq, void* gates_seq,
           void* c_seq, void* h_fin, void* c_fin, int K, int B, int U, int H,
           int S, int M, int smem, void* stream) {
  const void* kernel = kernel_for<T, RESIDUALS>(M);
  if (kernel == nullptr || (size_t)smem != smem_bytes(M, H, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, &cfg, &attr, B, U, H, M, smem, stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&w,     &b,    &xs,  &h0, &c0, &lvec, &h_seq, &gates_seq,
                  &c_seq, &h_fin, &c_fin, &K, &B, &U,  &H,     &S};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_fwd_f32(const void* w, const void* b, const void* xs,
                                 const void* h0, const void* c0,
                                 const void* lvec, void* h_seq, void* h_fin,
                                 void* c_fin, int K, int B, int U, int H,
                                 int S, int M, int smem, void* stream) {
  return launch<float, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr, nullptr,
                              h_fin, c_fin, K, B, U, H, S, M, smem, stream);
}

extern "C" int wavefront_fwd_bf16(const void* w, const void* b,
                                  const void* xs, const void* h0,
                                  const void* c0, const void* lvec,
                                  void* h_seq, void* h_fin, void* c_fin, int K,
                                  int B, int U, int H, int S, int M, int smem,
                                  void* stream) {
  return launch<__nv_bfloat16, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr,
                                      nullptr, h_fin, c_fin, K, B, U, H, S, M,
                                      smem, stream);
}

extern "C" int wavefront_fwd_res_f32(const void* w, const void* b,
                                     const void* xs, const void* h0,
                                     const void* c0, const void* lvec,
                                     void* h_seq, void* gates_seq, void* c_seq,
                                     void* h_fin, void* c_fin, int K, int B,
                                     int U, int H, int S, int M, int smem,
                                     void* stream) {
  return launch<float, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq, c_seq,
                             h_fin, c_fin, K, B, U, H, S, M, smem, stream);
}

extern "C" int wavefront_fwd_res_bf16(const void* w, const void* b,
                                      const void* xs, const void* h0,
                                      const void* c0, const void* lvec,
                                      void* h_seq, void* gates_seq,
                                      void* c_seq, void* h_fin, void* c_fin,
                                      int K, int B, int U, int H, int S, int M,
                                      int smem, void* stream) {
  return launch<__nv_bfloat16, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq,
                                     c_seq, h_fin, c_fin, K, B, U, H, S, M,
                                     smem, stream);
}

// How many clusters of the residual forward's launch for (B, U, H, M) the
// card holds at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error. The serving variant has the same shape and shared memory.
extern "C" int wavefront_fwd_max_clusters(int bf16, int B, int U, int H,
                                          int M, int smem) {
  const void* kernel = bf16 ? kernel_for<__nv_bfloat16, true>(M)
                            : kernel_for<float, true>(M);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, &cfg, &attr, B, U, H, M, smem, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
