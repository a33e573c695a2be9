// Reverse wavefront LSTM recurrence for Hopper (sm_90a), on thread-block
// clusters.
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
// cotangent of unit u+1 through dz, and its carried dh_tot and dc pass
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
// plain PyTorch (on the dense W_eff). __fmul_rn / __fadd_rn keep nvcc from
// contracting the elementwise chain into FMAs that the plain version does
// not do.
//
// W_eff is block-bidiagonal (models/blocks.py::_wavefront_pack), so row
// block u of W_eff^T's product needs only unit u's own dgates (recurrent
// block) and, when lvec[u+1] > 0, unit u+1's (feed block):
//   dz_u = dg_u @ W_hh,u^T + dg_{u+1} @ W_ih,u+1^T.
// The wrapper (kernels/wavefront.py) hands the kernel those blocks only, per
// unit Wb[u] (H, 8H): row block u of W_eff, its own gate columns then unit
// u+1's (or zeros).
//
// What bounds it on the card: 2 * H * 4H fp32 FMAs per non-zero block, per
// row, per step: 4.45 GFLOP at B=32, K=303, H=64 with 14 blocks, 66 us at
// 67 TFLOP/s (the bytes, ~220 MB, take 66 us as well). In practice the
// 303-step dependency chain sets the floor.
//
// The first design (one block per batch row) used 32 of 132 SMs at B=32 and
// streamed all of W_eff^T (4 MB fp32, a transposed copy made per call, 78%
// zero blocks) from L2 on every step, 27 ms per call. This design: one
// thread-block cluster of U CTAs per group of M batch rows, CTA u owning
// unit u, on the skeleton of wavefront_fwd.cu.
//   - CTA u loads Wb[u] (128 KB fp32, 64 KB bf16 at H = 64) into shared
//     memory once, as [8H][H] (depth, state column), and keeps it for all K
//     steps. The wrapper forms it with one gather per call (no transposed
//     copy of W_eff).
//   - Cell phase: thread (rp, t) = threadIdx.x = rp * H + t owns state
//     column t of rows m = rp, rp + 4, ... (dh, dc in registers) and
//     computes their four dgates.
//   - Product phase: dz[m, t] is an 8H-deep dot product (4H when unit u+1 is
//     not fed by u). Thread (ks, cg) = threadIdx.x = ks * H/4 + cg forms the
//     four columns t = 4cg .. 4cg + 3 for all M rows over depth slice ks of
//     16 (depths 4 d4 .. 4 d4 + 3 for d4 = ks, ks + 16, ...): each 16-byte
//     weight load brings four columns of one depth, so one broadcast read of
//     the dgates serves four columns. The 16 slices' partial sums meet in
//     shared memory; after one CTA barrier thread (rp, t) sums them.
//   - The dgates are double-buffered in shared memory as [2][M][own 4H |
//     unit u+1's 4H]. CTA u writes its own into its buffer and, when
//     lvec[u] > 0, into CTA u-1's with st.async (distributed shared
//     memory), counted by an mbarrier in CTA u-1 that CTA u-1 waits on
//     before its product. A relaxed cluster barrier per step (arrive after
//     the product, wait at the end of the step) keeps a CTA from refilling
//     a neighbour's buffer before the neighbour has read it. Step k writes
//     and reads buffer k&1.
//   - The next step's gates_seq, c_seq, c_prev_seq and dY rows are
//     prefetched into shared memory with cp.async while the product runs;
//     the CTA barrier that publishes the partial sums also publishes them.
//   M is chosen by kernels/wavefront.py::_launch_plan so that all clusters
//   are resident at once (asked of the card with
//   cudaOccupancyMaxActiveClusters), as for the forward; every CTA asks for
//   at least half an SM's shared memory, so that two never share one.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_common.cuh"

namespace {

constexpr int NSEG = 7;   // prefetched segments per row: 4 gates, c, c_prev, dY

// x * y * (1 - y), evaluated left to right without contraction
__device__ __forceinline__ float mul_dsig(float x, float y) {
  return __fmul_rn(__fmul_rn(x, y), __fsub_rn(1.0f, y));
}

size_t smem_bytes(int M, int H, size_t item) {
  return 16                               // two mbarriers
         + (size_t)8 * H * H * item       // Wb[u]
         + (size_t)2 * M * 8 * H * 4      // dgates, double-buffered
         + (size_t)16 * M * H * 4         // partial dz of the 16 slices
         + (size_t)M * NSEG * H * item;   // residual rows of one step
}

// 4H <= 256 threads (the wrapper's planner refuses more), so a thread may
// hold up to 255 registers
template <typename T, int M>
__global__ void __launch_bounds__(256, 1)
    wavefront_bwd_kernel(const T* __restrict__ wb,
                         const T* __restrict__ gates_seq,
                         const T* __restrict__ c_seq,
                         const T* __restrict__ c_prev_seq,
                         const T* __restrict__ dy, const T* __restrict__ dh0,
                         const T* __restrict__ dc0,
                         const int* __restrict__ lvec,
                         T* __restrict__ dgates_seq, T* __restrict__ dh_fin,
                         T* __restrict__ dc_fin, int K, int B, int U, int H,
                         int S) {
  constexpr int R = (M + 3) / 4;  // rows m = rp + 4r whose cell this thread owns
  constexpr int V = 16 / sizeof(T);         // storage values per 16-byte copy
  constexpr int J = (M * NSEG + 4 * V - 1) / (4 * V);  // copies per thread
  cg::cluster_group cluster = cg::this_cluster();
  const int u = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * M;
  const int tid = threadIdx.x;
  const int rp = tid / H, t = tid % H;                // cell phase
  const int ks = tid / (H / 4), cg4 = tid % (H / 4);  // product phase
  const int UH = U * H, G = 4 * UH;
  const int layer = lvec[u];
  const bool feed_in = layer > 0;    // unit u-1 fed unit u: send dgates down
  const bool feed_out = u + 1 < U && lvec[u + 1] > 0;  // receive from u+1
  const int depth4 = (feed_out ? 8 * H : 4 * H) / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  T* w_s = reinterpret_cast<T*>(smem + 16);
  float* dg_s = reinterpret_cast<float*>(smem + 16 + (size_t)8 * H * H * sizeof(T));
  float* part = dg_s + 2 * M * 8 * H;                      // [16][M][H]
  T* p_s = reinterpret_cast<T*>(part + 16 * M * H);        // [M][NSEG][H]
  // unit u-1's dgates buffers and mbarriers, as cluster addresses
  const unsigned dg_pred = cluster_addr(smem_addr(dg_s), u > 0 ? u - 1 : u);
  const unsigned full_pred = cluster_addr(smem_addr(full), u > 0 ? u - 1 : u);

  if (tid == 0) {  // full[b]: unit u+1's dgates have landed in buffer b
    mbar_init(smem_addr(full));
    mbar_init(smem_addr(full + 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (feed_out) {
      mbar_expect(smem_addr(full), M * 4 * H * 4);
      mbar_expect(smem_addr(full + 1), M * 4 * H * 4);
    }
  }
  {  // Wb[u] stays resident for all K steps
    const uint4* src =
        reinterpret_cast<const uint4*>(wb + (size_t)u * 8 * H * H);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n = (int)((size_t)8 * H * H * sizeof(T) / 16);
    for (int i = tid; i < n; i += blockDim.x) dst[i] = src[i];
  }
  float dh[R], dc[R], dh_tot[R], dct[R], fg[R], dg[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t off = (size_t)min(row0 + rp + 4 * r, B - 1) * UH + u * H + t;
    dh[r] = load_f32(dh0 + off);
    dc[r] = load_f32(dc0 + off);
  }
  // this thread's 16-byte copies of a step's residual rows: the source at
  // step 0 and its stride per step, and the destination in p_s; rows past
  // the batch read the last row (their results are never stored)
  const T* src0[J];
  size_t src_step[J];
  int dst_off[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = tid + j * blockDim.x, per_seg = H / V;
    const int c = i % per_seg, seg = (i / per_seg) % NSEG;
    const int m = i / (NSEG * per_seg);
    const size_t row = min(row0 + m, B - 1);
    if (seg < 4) {
      src0[j] = gates_seq + row * G + (size_t)seg * UH + u * H + c * V;
      src_step[j] = (size_t)B * G;
    } else {
      src0[j] = (seg == 4 ? c_seq : seg == 5 ? c_prev_seq : dy) + row * UH +
                u * H + c * V;
      src_step[j] = (size_t)B * UH;
    }
    dst_off[j] = i < M * NSEG * per_seg ? (m * NSEG + seg) * H + c * V : -1;
  }
  auto prefetch_step = [&](int k) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (dst_off[j] >= 0)
        cp_async16(p_s + dst_off[j], src0[j] + (size_t)k * src_step[j]);
    cp_async_commit();
  };
  prefetch_step(K - 1);
  cp_async_wait_all();
  cluster_sync_full();  // every CTA runs, its mbarriers and rows are in place

  unsigned parity[2] = {0u, 0u};
  for (int k = K - 1; k >= 0; --k) {
    const int cur = k & 1;
    const bool valid = layer <= k && k < S + layer;
    float* dgb = dg_s + cur * M * 8 * H;
    // cell phase: dgates of state column t for rows m = rp + 4r (rows past
    // M recompute row M-1 and store nothing, so the R rows' math
    // interleaves)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* pm = p_s + min(rp + 4 * r, M - 1) * NSEG * H + t;
      dh_tot[r] = __fadd_rn(dh[r], load_f32(pm + 6 * H));
      const float ig = sigmoid(load_f32(pm));
      fg[r] = sigmoid(load_f32(pm + H));
      const float gt = tanhf(load_f32(pm + 2 * H));
      const float og = sigmoid(load_f32(pm + 3 * H));
      const float tc = tanhf(load_f32(pm + 4 * H));
      const float cprev = load_f32(pm + 5 * H);
      const float d_o = __fmul_rn(dh_tot[r], tc);
      dct[r] = __fadd_rn(dc[r], __fmul_rn(__fmul_rn(dh_tot[r], og),
                                          __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      dg[r][0] = dg[r][1] = dg[r][2] = dg[r][3] = 0.f;
      if (valid) {
        dg[r][0] = round_to(mul_dsig(__fmul_rn(dct[r], gt), ig), dh0);
        dg[r][1] = round_to(mul_dsig(__fmul_rn(dct[r], cprev), fg[r]), dh0);
        dg[r][2] = round_to(__fmul_rn(__fmul_rn(dct[r], ig),
                                      __fsub_rn(1.0f, __fmul_rn(gt, gt))), dh0);
        dg[r][3] = round_to(mul_dsig(d_o, og), dh0);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = rp + 4 * r;
      if (m < M) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dgb[m * 8 * H + q * H + t] = dg[r][q];
          if (feed_in)  // unit u-1 finished reading this buffer 2 steps ago
            st_async(dg_pred + ((cur * M + m) * 8 * H + 4 * H + q * H + t) * 4,
                     dg[r][q], full_pred + cur * 8);
        }
        const int row = row0 + m;
        if (row < B) {
          T* out = dgates_seq + ((size_t)k * B + row) * G + u * H + t;
#pragma unroll
          for (int q = 0; q < 4; ++q) store(out + q * UH, dg[r][q]);
        }
      }
    }
    __syncthreads();  // own dgates visible; p_s read by every thread
    if (feed_out) {   // unit u+1's dgates of step k have landed
      mbar_wait(smem_addr(full + cur), parity[cur]);
      parity[cur] ^= 1u;
      if (tid == 0) mbar_expect(smem_addr(full + cur), M * 4 * H * 4);
    }
    if (k > 0) prefetch_step(k - 1);
    // product phase: slice ks of [dg_u | dg_{u+1}] @ Wb[u]^T, columns 4cg..
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll 2
    for (int d4 = ks; d4 < depth4; d4 += 16) {
      const T* wp = w_s + (size_t)d4 * 4 * H + 4 * cg4;
      const float4 w0 = load4(wp), w1 = load4(wp + H);
      const float4 w2 = load4(wp + 2 * H), w3 = load4(wp + 3 * H);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 d = *reinterpret_cast<const float4*>(dgb + m * 8 * H + 4 * d4);
        acc[m][0] = fmaf(d.w, w3.x, fmaf(d.z, w2.x, fmaf(d.y, w1.x, fmaf(d.x, w0.x, acc[m][0]))));
        acc[m][1] = fmaf(d.w, w3.y, fmaf(d.z, w2.y, fmaf(d.y, w1.y, fmaf(d.x, w0.y, acc[m][1]))));
        acc[m][2] = fmaf(d.w, w3.z, fmaf(d.z, w2.z, fmaf(d.y, w1.z, fmaf(d.x, w0.z, acc[m][2]))));
        acc[m][3] = fmaf(d.w, w3.w, fmaf(d.z, w2.w, fmaf(d.y, w1.w, fmaf(d.x, w0.w, acc[m][3]))));
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      *reinterpret_cast<float4*>(part + (ks * M + m) * H + 4 * cg4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    // this CTA is done with dgates buffer cur: unit u+1 may refill it
    cluster_arrive_relaxed();
    cp_async_wait_all();  // step k-1's rows landed (this thread's copies)
    __syncthreads();      // partial sums and step k-1's rows visible
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* p = part + min(rp + 4 * r, M - 1) * H + t;
      const int sl = M * H;  // one slice's partials
      float s4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s4[j] = __fadd_rn(__fadd_rn(p[j * sl], p[(j + 4) * sl]),
                          __fadd_rn(p[(j + 8) * sl], p[(j + 12) * sl]));
      const float dz = __fadd_rn(__fadd_rn(s4[0], s4[1]),
                                 __fadd_rn(s4[2], s4[3]));
      dh[r] = round_to(valid ? dz : __fadd_rn(dz, dh_tot[r]), dh0);
      dc[r] = round_to(valid ? __fmul_rn(dct[r], fg[r]) : dc[r], dh0);
    }
    cluster_wait();  // every CTA is done with its dgates buffer cur
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + rp + 4 * r;
    if (rp + 4 * r < M && row < B) {
      store(dh_fin + (size_t)row * UH + u * H + t, dh[r]);
      store(dc_fin + (size_t)row * UH + u * H + t, dc[r]);
    }
  }
}

#define WAVEFRONT_BWD_CASE(m) \
  case m:                       \
    return (const void*)wavefront_bwd_kernel<T, m>;

// the kernel for M rows per cluster, 1 <= M <= 10
template <typename T>
const void* kernel_for(int M) {
  switch (M) {
    WAVEFRONT_BWD_CASE(1) WAVEFRONT_BWD_CASE(2) WAVEFRONT_BWD_CASE(3)
    WAVEFRONT_BWD_CASE(4) WAVEFRONT_BWD_CASE(5) WAVEFRONT_BWD_CASE(6)
    WAVEFRONT_BWD_CASE(7) WAVEFRONT_BWD_CASE(8) WAVEFRONT_BWD_CASE(9)
    WAVEFRONT_BWD_CASE(10)
  }
  return nullptr;
}

template <typename T>
int launch(const void* wb, const void* gates_seq, const void* c_seq,
           const void* c_prev_seq, const void* dy, const void* dh0,
           const void* dc0, const void* lvec, void* dgates_seq, void* dh_fin,
           void* dc_fin, int K, int B, int U, int H, int S, int M, int smem,
           void* stream) {
  const void* kernel = kernel_for<T>(M);
  if (kernel == nullptr || (size_t)smem != smem_bytes(M, H, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, &cfg, &attr, B, U, H, M, smem, stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&wb,   &gates_seq,  &c_seq,  &c_prev_seq, &dy, &dh0,
                  &dc0,  &lvec,       &dgates_seq, &dh_fin, &dc_fin, &K,
                  &B,    &U,          &H,     &S};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_bwd_f32(const void* wb, const void* gates_seq,
                                 const void* c_seq, const void* c_prev_seq,
                                 const void* dy, const void* dh0,
                                 const void* dc0, const void* lvec,
                                 void* dgates_seq, void* dh_fin, void* dc_fin,
                                 int K, int B, int U, int H, int S, int M,
                                 int smem, void* stream) {
  return launch<float>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0, lvec,
                       dgates_seq, dh_fin, dc_fin, K, B, U, H, S, M, smem,
                       stream);
}

extern "C" int wavefront_bwd_bf16(const void* wb, const void* gates_seq,
                                  const void* c_seq, const void* c_prev_seq,
                                  const void* dy, const void* dh0,
                                  const void* dc0, const void* lvec,
                                  void* dgates_seq, void* dh_fin,
                                  void* dc_fin, int K, int B, int U, int H,
                                  int S, int M, int smem, void* stream) {
  return launch<__nv_bfloat16>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                               lvec, dgates_seq, dh_fin, dc_fin, K, B, U, H,
                               S, M, smem, stream);
}

// How many clusters of the launch for (B, U, H, M) the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int wavefront_bwd_max_clusters(int bf16, int B, int U, int H,
                                          int M, int smem) {
  const void* kernel =
      bf16 ? kernel_for<__nv_bfloat16>(M) : kernel_for<float>(M);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, &cfg, &attr, B, U, H, M, smem, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
