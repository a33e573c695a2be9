// Device helpers and the launch shared by wavefront_grid_fwd.cu and
// wavefront_grid_bwd.cu (kernels/build.py hashes this header into every
// library's name, so an edit rebuilds them): the shared-memory layout, the
// per-unit step flags, the stage ring (bulk copies multicast to a cluster,
// mbarriers for full and empty buffers), the tensor-core products, and the
// cooperative cluster launch with its residency query.
//
// A grid CTA runs 8 consumer warps (the products and the cells) and one
// producer warp (every copy). A step's exchanged rows come in stages of one
// unit's H columns (forward: h of units u, u-1; reverse: the four gates'
// dgates of units u, u+1), each stage all the pass's batch rows, into a
// buffer of its own where the shared memory holds all of a step's stages,
// else into a ring of NBUF buffers. Each CTA of a cluster copies 1/CS of a
// stage's rows from L2 and multicasts them into the same buffer of every
// CTA of the cluster (cp.async.bulk ... .multicast::cluster), whose `full`
// mbarrier counts the bytes. A buffer of its own is refilled only at the
// next step, after the step flags say that every CTA of the unit (so of
// the cluster) is past its product; a ring buffer is refilled within the
// step, once every CTA of the cluster is done with it: the consumers meet
// (bar.sync), and one arrival from each CTA on the buffer's `empty`
// mbarrier in every CTA of the cluster lets the producer copy. The
// step-independent inputs come by cp.async a step ahead into two more
// buffers, each of the producer's lanes arriving on an `in` mbarrier when
// its copies land.
//
// The streamed mode (template flag STREAM of both kernels, plan kind
// "stream") is for the shapes whose weight slice does not fit a CTA's
// shared memory: nothing that grows with H stays resident. The wrapper
// packs each CTA's slice in global memory as tiles in mma-fragment order,
// one per (unit, column block, stage, k-chunk of KC depths), each one
// contiguous; a step is a pipelined k-loop over its stages' chunks, each
// chunk one ring slot holding the weight tile (one bulk copy into this
// CTA) and the chunk's KC columns of the stage's rows (multicast to the
// cluster as above). Every consumer warp releases a slot on its own (the
// `empty` mbarrier counts WARPS arrivals from each CTA of the cluster),
// so warps run up to the ring's depth apart.

#pragma once

#include "wavefront_common.cuh"

namespace {

constexpr int WARPS = 8;                  // consumer warps
constexpr int CONSUMERS = 32 * WARPS;     // their threads
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int MAX_BUFS = 8;               // stage buffers of the ring
constexpr int MAX_ROWS = 32;              // batch rows a pass
constexpr int FLAG_STRIDE = 32;           // u32 from a unit's flag to the next
constexpr int BAR_BYTES = 256;            // full[8], empty[8], in[2] mbarriers

__host__ __device__ inline size_t up128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Where a grid CTA keeps what, as kernels/wavefront.py::_grid_layout mirrors
// it. The step's product is D[M][Nn] = A[M][depth] x B[depth][Nn] on m16n8
// tiles: forward A = the weight slice (M = the 4N gate columns), B = the
// staged h rows (Nn = batch rows); reverse A = the staged dgates rows (M =
// batch rows), B = the weight slice (Nn = the N state columns).
struct Layout {
  int kw;      // depth of one mma: 8 (tf32) or 16 (bf16)
  int kts;     // k-tiles of one stage: H rounded up to kw, over kw
  int rs;      // stage row stride in storage values (16 bytes of padding)
  int stages;  // the most stages a step has: 2 forward, 8 reverse
  int rows;    // stage rows: the pass's batch rows rounded up to the tile
  int mt, nt;  // m16 and n8 tiles of the step's product
  int ks;      // depth slices, WARPS / mt: warp w takes m-tile w % mt and
               // the k-tiles j = w / mt (mod ks) of every stage
  int cols;    // output columns: 4N forward, N reverse
  int ps;      // row stride of the slices' sums: 4N + 8 forward, N reverse,
               // so that a warp's cells read 32 banks
  size_t w, buf, part, in, bias, carry, total;  // byte offsets, size
  // streamed mode: a ring slot is a weight tile (wt bytes) and the rows'
  // chunk (rows x rsc storage values); kc depths a chunk, kpc k-tiles
  int kc, kpc, rsc;
  size_t slot, wt;
};

// The regions after the ring, from byte `off`, as kernels/wavefront.py::
// _layout_tail mirrors it: the depth slices' sums, two steps' inputs, the
// forward's bias, the carried state; sets L.total
template <typename T, bool FWD>
__host__ __device__ inline void layout_tail(Layout& L, size_t off, int MB,
                                            int N) {
  L.part = off = up128(off);  // the depth slices' sums, fp32 [ks][rows][ps]
  off = up128(off + (size_t)L.ks * L.rows * L.ps * 4);
  L.in = off;  // two steps' inputs [2][MB][segments][N]
  off = up128(off + (size_t)2 * MB * (FWD ? 4 : 7) * N * sizeof(T));
  L.bias = off;  // forward: the slice of b, fp32 [4N]
  off = up128(off + (FWD ? (size_t)16 * N : 0));
  L.carry = off;  // carried state, fp32 [MB][N]: h, c / dh, dc, dh_tot
  L.total = up128(off + (size_t)(FWD ? 2 : 3) * MB * N * 4);
}

template <typename T, bool FWD>
__host__ __device__ inline Layout grid_layout(int H, int N, int MB, int nbuf) {
  Layout L;
  const int item = (int)sizeof(T);
  L.kw = item == 4 ? 8 : 16;
  L.kts = (H + L.kw - 1) / L.kw;
  L.rs = L.kts * L.kw + 16 / item;
  L.stages = FWD ? 2 : 8;
  L.rows = FWD ? (MB + 7) / 8 * 8 : (MB + 15) / 16 * 16;
  L.mt = FWD ? N / 4 : L.rows / 16;
  L.nt = FWD ? L.rows / 8 : N / 8;
  L.ks = WARPS / L.mt;
  L.cols = FWD ? 4 * N : N;
  L.ps = FWD ? L.cols + 8 : L.cols;
  size_t off = BAR_BYTES;
  L.w = off;  // weight fragments: 4 registers (A) or 2 (B) a lane
  off = up128(off + (size_t)(FWD ? L.mt : L.nt) * L.stages * L.kts * 32 *
                        (FWD ? 16 : 8));
  L.buf = off;  // the ring: nbuf x rows x rs
  layout_tail<T, FWD>(L, off + (size_t)nbuf * L.rows * L.rs * item, MB, N);
  L.kc = L.kpc = L.rsc = 0;
  L.slot = L.wt = 0;
  return L;
}

// The streamed mode's layout, as kernels/wavefront.py::_stream_layout
// mirrors it: 256 bytes of mbarriers; the ring of nbuf slots, each the
// chunk's weight tile (forward 4N x kc, reverse kc x N storage values, in
// fragment order) and the chunk of the pass's rows (rounded up to 8 / 16)
// at a stride of kc values plus 16 bytes; then the depth slices' sums, two
// steps' inputs, the forward's bias and the carried state as in
// grid_layout. The forward's m-tiles (4N / 16) are spread over at most the
// 8 warps: at N = 64 each warp takes two.
template <typename T, bool FWD>
__host__ __device__ inline Layout stream_layout(int H, int N, int MB, int nbuf,
                                                int kc) {
  Layout L;
  const int item = (int)sizeof(T);
  L.kw = item == 4 ? 8 : 16;
  L.kc = kc;
  L.kpc = kc / L.kw;
  L.kts = 0;
  L.rs = 0;
  L.rsc = kc + 16 / item;
  L.stages = FWD ? 2 : 8;
  L.rows = FWD ? (MB + 7) / 8 * 8 : (MB + 15) / 16 * 16;
  L.mt = FWD ? N / 4 : L.rows / 16;
  L.nt = FWD ? L.rows / 8 : N / 8;
  L.ks = L.mt >= WARPS ? 1 : WARPS / L.mt;
  L.cols = FWD ? 4 * N : N;
  L.ps = FWD ? L.cols + 8 : L.cols;
  L.wt = (size_t)L.cols * kc * item;
  L.slot = up128(L.wt + (size_t)L.rows * L.rsc * item);
  L.w = L.buf = BAR_BYTES;
  layout_tail<T, FWD>(L, L.buf + (size_t)nbuf * L.slot, MB, N);
  return L;
}

// The streamed tiles of unit u start after those of the units before it:
// `stages(v)` tiles of each of its per_unit column blocks and nc chunks
template <typename F>
__device__ __forceinline__ size_t units_tiles(int u, int per_unit, int nc,
                                              F stages) {
  size_t n = 0;
  for (int v = 0; v < u; ++v) n += (size_t)stages(v);
  return n * per_unit * nc;
}

__device__ __forceinline__ unsigned full_bar(unsigned bars, int i) {
  return bars + 8 * i;
}
__device__ __forceinline__ unsigned empty_bar(unsigned bars, int i) {
  return bars + 64 + 8 * i;
}
__device__ __forceinline__ unsigned in_bar(unsigned bars, int j) {
  return bars + 128 + 8 * j;
}

__device__ __forceinline__ void mbar_init_n(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_local(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive on the mbarrier at this cluster address (another CTA's)
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Which buffer stage s of step e (the g-th stage of the launch) takes, and
// the how-manieth use of that buffer it is
struct Slot {
  int buf, use;
};
__device__ __forceinline__ Slot stage_slot(bool ring, int nbuf, int g, int s,
                                           int e) {
  return ring ? Slot{g % nbuf, g / nbuf} : Slot{s, e};
}

// The consumers are done with a ring buffer: after they meet, one arrival
// on that buffer's `empty` mbarrier in each of the cluster's CTAs (lane r
// of warp 0 to rank r)
__device__ __forceinline__ void release_stage(unsigned bar, int cs, int warp,
                                              int lane) {
  consumers_sync();
  if (warp == 0) {
    if (cs == 1) {
      if (lane == 0) mbar_arrive_local(bar);
    } else if (lane < cs) {
      mbar_arrive_remote(cluster_addr(bar, lane));
    }
  }
}

// A consumer warp of the streamed mode is done with a ring slot: one
// arrival on that slot's `empty` mbarrier in each of the cluster's CTAs
// (lane r to rank r), after every lane's reads of the slot
__device__ __forceinline__ void release_slot(unsigned bar, int cs, int lane) {
  __syncwarp();
  if (cs == 1) {
    if (lane == 0) mbar_arrive_local(bar);
  } else if (lane < cs) {
    mbar_arrive_remote(cluster_addr(bar, lane));
  }
}

// cp.async copies of this thread land: one arrival on `bar` (counted in
// its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Bulk copies global -> shared, counted in bytes on an mbarrier: into this
// CTA, or multicast to the same offset of every CTA in `mask`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_copy_mc(unsigned dst, const void* src,
                                             unsigned bytes, unsigned bar,
                                             unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// The step flags: unit v's counter (v * FLAG_STRIDE) gains one from each of
// its H / N CTAs per step, after the CTA's outputs of that step are in
// global memory; the wrapper zeroes the counters before every launch.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
// Consumer thread 0, after every consumer's stores of the step (bar.sync,
// which the release makes cumulative): order them before the arrival, for
// generic and bulk-copy readers alike
__device__ __forceinline__ void publish_step(unsigned* flag) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(flag),
               "r"(1u)
               : "memory");
}
// Producer warp: wait until `flag` reaches `target` (lane 0 polls; the
// warp barrier orders the other lanes after its acquire) before bulk
// copies read what it guards
__device__ __forceinline__ void wait_flag(const unsigned* flag,
                                          unsigned target, int lane) {
  if (lane == 0)
    while (ld_acquire(flag) < target) {
    }
  __syncwarp();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Thread 0 initialises the mbarriers; every thread then orders its zero
// fill of the ring before the bulk copies that overwrite it, and the
// cluster's CTAs meet, so that no copy or remote arrival reaches a CTA
// whose mbarriers are not yet initialised.
// `releases` arrivals from each CTA of the cluster free a ring buffer: one
// (the consumers meet first) or, in the streamed mode, one a warp.
__device__ __forceinline__ void grid_init_barriers(unsigned bars, int nbuf,
                                                   int cs, int releases = 1) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i) {
      mbar_init_n(full_bar(bars, i), 1);
      mbar_init_n(empty_bar(bars, i), cs * releases);
    }
    mbar_init_n(in_bar(bars, 0), 32);
    mbar_init_n(in_bar(bars, 1), 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}
__device__ __forceinline__ void grid_start(int cs) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (cs > 1) cluster_sync_full();
}
// No CTA leaves while a peer may still arrive on its mbarriers
__device__ __forceinline__ void grid_end(int cs) {
  if (cs > 1) cluster_sync_full();
}

// ---- tensor-core products ----

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, in two integer operations on the bits
__device__ __forceinline__ unsigned tf32_rna(unsigned x) {
  return (x + 0x1000u) & 0xffffe000u;
}
// x = big + small (3xTF32 keeps big*big + big*small + small*big): big the
// tf32 rounding of x, small the exact rest, handed to the mma unrounded
// (the tensor cores read a tf32 operand's top 19 bits)
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(x);
  small = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-tile of one m16n8 output tile. fp32 storage: 3xTF32 into three
// accumulators (big*big, big*small, small*big), summed at the end as
// acc[0] + (acc[1] + acc[2]); bf16 storage: one bf16 mma into acc[0].
// a_hi/b_hi hold the raw storage bits (fp32, or two bf16 a register);
// a_lo/b_lo the tf32 remainders (fp32 only).
template <typename T>
__device__ __forceinline__ void mma_step(float (&acc)[3][4],
                                         const unsigned (&a_hi)[4],
                                         const unsigned (&a_lo)[4],
                                         const unsigned (&b_hi)[2],
                                         const unsigned (&b_lo)[2]) {
  if (sizeof(T) == 2) {
    mma_bf16(acc[0], a_hi, b_hi);
  } else {
    mma_tf32(acc[0], a_hi, b_hi);
    mma_tf32(acc[1], a_hi, b_lo);
    mma_tf32(acc[2], a_lo, b_hi);
  }
}
template <typename T, int R>
__device__ __forceinline__ void split_frag(unsigned (&hi)[R],
                                           unsigned (&lo)[R]) {
  if (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < R; ++i) split_tf32(hi[i], hi[i], lo[i]);
  }
}
// Accumulator sets a warp keeps per output tile, so that at least four
// mma chains are in flight (an mma.sync takes ~29 cycles, one issues every
// ~7 on a sub-partition): k-tile i of a warp's sequence in a stage goes to
// set i % SETS
__host__ __device__ constexpr int sets_for(int nt) {
  return nt >= 3 ? 1 : 4 / nt;
}

// One stage of a warp's product: its k-tiles j = slice, slice + ks, ... <
// kts; load_a(j, hi) and load_b(j, n, hi) give the raw fragments
template <typename T, int NT, int SETS, typename FA, typename FB>
__device__ __forceinline__ void stage_product(float (&acc)[SETS][NT][3][4],
                                              int slice, int kts, int ks,
                                              FA load_a, FB load_b) {
  for (int j0 = slice; j0 < kts; j0 += SETS * ks) {
#pragma unroll
    for (int q = 0; q < SETS; ++q) {
      const int j = j0 + q * ks;
      if (j < kts) {
        unsigned a_hi[4], a_lo[4], b_hi[NT][2], b_lo[NT][2];
        load_a(j, a_hi);
#pragma unroll
        for (int n = 0; n < NT; ++n) load_b(j, n, b_hi[n]);
        split_frag<T, 4>(a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split_frag<T, 2>(b_hi[n], b_lo[n]);
          mma_step<T>(acc[q][n], a_hi, a_lo, b_hi[n], b_lo[n]);
        }
      }
    }
  }
}

template <int SETS, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[SETS][NT][3][4]) {
#pragma unroll
  for (int q = 0; q < SETS; ++q)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][n][a][i] = 0.f;
}

// Element i of output tile n: per set acc[0] + (acc[1] + acc[2]) (3xTF32)
// or acc[0] (bf16), the sets added in order
template <int SETS, int NT>
__device__ __forceinline__ float acc_sum(const float (&acc)[SETS][NT][3][4],
                                         int n, int i, bool tf32) {
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < SETS; ++q) {
    const float(&a)[3][4] = acc[q][n];
    const float s =
        tf32 ? __fadd_rn(a[0][i], __fadd_rn(a[1][i], a[2][i])) : a[0][i];
    v = q ? __fadd_rn(v, s) : s;
  }
  return v;
}

// ---- launch ----

// Launch `kernel` (one by-value parameter struct) as one cooperative grid
// of `ctas` CTAs in clusters of `cs`, all resident at once or refused.
int grid_launch(const void* kernel, void* params, int ctas, int cs, int smem,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cs;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 2 : 1;
  void* args[] = {params};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many CTAs of `kernel` with `smem` bytes of dynamic shared memory the
// card holds at once in clusters of `cs` (cudaOccupancyMaxActiveClusters
// times cs; for cs = 1 blocks per SM times SMs), or minus the CUDA error.
int grid_max_ctas(const void* kernel, int smem, int cs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  if (cs > 1) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n * cs : -(int)err;
  }
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// The launch parameters a grid kernel accepts (cudaErrorInvalidValue
// otherwise): N of 8, 16, 32 dividing H, a multiple of 8; clusters of 1, 2,
// 4 or 8 CTAs of one unit; 1-32 rows a pass; 1-8 ring buffers; `smem` as
// grid_layout gives it.
inline bool grid_args_ok(int H, int N, int CS, int MB, int nbuf, int smem,
                         size_t total) {
  return (N == 8 || N == 16 || N == 32) && H % 8 == 0 && H % N == 0 &&
         (CS == 1 || CS == 2 || CS == 4 || CS == 8) && (H / N) % CS == 0 &&
         MB >= 1 && MB <= MAX_ROWS && nbuf >= 1 && nbuf <= MAX_BUFS &&
         (size_t)smem == total;
}

// ... and the streamed mode's: N of 8, 16, 32 or 64, ceil(H / N) CTAs a
// unit (the last may own fewer columns); chunks of 1, 2, 4, 8, 16 or 32
// k-tiles (kw = 8 tf32, 16 bf16 depths each); a ring of at least 2 slots
inline bool stream_args_ok(int H, int N, int CS, int MB, int nbuf, int kc,
                           int kw, int smem, size_t total) {
  return (N == 8 || N == 16 || N == 32 || N == 64) && H % 8 == 0 &&
         (CS == 1 || CS == 2 || CS == 4 || CS == 8) &&
         ((H + N - 1) / N) % CS == 0 && MB >= 1 && MB <= MAX_ROWS &&
         nbuf >= 2 &&
         nbuf <= MAX_BUFS &&
         kc % kw == 0 && kc / kw <= 32 && ((kc / kw) & (kc / kw - 1)) == 0 &&
         (size_t)smem == total;
}

}  // namespace
