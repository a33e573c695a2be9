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
// shared memory. The wrapper packs each CTA's slice in global memory as
// tiles in mma-fragment order, one per (unit, column block, stage, k-chunk
// of KC depths), each one contiguous; a step is a k-loop over its stages'
// chunks. The last KR chunks of a CTA's step (the plan's resident share,
// what the 227 KB hold beside the rings) stay in shared memory for all K
// steps, loaded once by one bulk copy; the others stream every step
// through a ring of weight slots that a weights warp fills as fast as the
// consumers free them, across step boundaries, since no weight depends on
// the step. The stage's rows (h or dgates) come through a second ring,
// after the step flags, in rows chunks of RC columns (up to 2 KB a row,
// whole weight chunks): each CTA of a cluster copies its 1/CS of a rows
// chunk with one tensor-map copy (cp.async.bulk.tensor, 128-byte swizzle,
// multicast to the cluster), a box of 128-byte pieces x rows x pieces, and
// the consumers load their fragments from it by ldmatrix. The consumers
// release a chunk's slots together, once they meet (one arrival from each
// CTA of the cluster frees a rows slot, one from its own CTA a weight
// slot), so that a step takes few hand-offs.

#pragma once

#include <cuda.h>

#include "wavefront_common.cuh"

namespace {

constexpr int WARPS = 8;                  // consumer warps
constexpr int CONSUMERS = 32 * WARPS;     // their threads
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
// the streamed mode's: a weights warp and a rows warp
constexpr int STREAM_THREADS = CONSUMERS + 64;
constexpr int MAX_BUFS = 8;               // stage buffers of the ring
constexpr int MAX_ROWS = 32;              // batch rows a pass
constexpr int FLAG_STRIDE = 32;           // u32 from a unit's flag to the next
constexpr int BAR_BYTES = 256;            // full[8], empty[8], in[2] mbarriers
// the streamed mode's mbarriers (also those of the weight ring and of the
// resident chunks), padded so that the rows' ring starts on the 1024
// bytes a 128-byte swizzle repeats after
constexpr int STREAM_BAR_BYTES = 1024;

__host__ __device__ inline size_t up128(size_t x) {
  return (x + 127) / 128 * 128;
}
__host__ __device__ inline size_t up1024(size_t x) {
  return (x + 1023) / 1024 * 1024;
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
  // streamed mode: kc depths a weight chunk (kpc k-tiles), rc depths a
  // rows chunk (`pieces` of 128 bytes a row, rc / kc weight chunks); the
  // rows' ring at `buf`, slots of `slot` bytes, each CS parts of `rank`
  // bytes (one CTA's share of `share` rows: [pieces][share][128 bytes],
  // 128-byte swizzled); the weight ring at `w`, slots of `wt` bytes (a
  // chunk's tile); kr resident chunks' tiles at `res`
  int kc, kpc, rc, pieces, share, kr;
  size_t slot, wt, rank, res;
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
  L.kc = L.kpc = L.rc = L.pieces = L.share = L.kr = 0;
  L.slot = L.wt = L.rank = L.res = 0;
  return L;
}

// The streamed mode's layout, as kernels/wavefront.py::_stream_layout
// mirrors it: STREAM_BAR_BYTES of mbarriers; the rows' ring of nbuf slots,
// each CS parts (1024-byte aligned) of the pass's rows (rounded up to 8 /
// 16) / CS by rc values, as the tensor copies land them; the weight ring of
// nbuf slots, each a chunk's tile (forward 4N x kc, reverse kc x N storage
// values, in fragment order); kr resident tiles; then the depth slices'
// sums, two steps' inputs, the forward's bias and the carried state as in
// grid_layout. The forward's m-tiles (4N / 16) are spread over at most the
// 8 warps: at N = 64 each warp takes two.
template <typename T, bool FWD>
__host__ __device__ inline Layout stream_layout(int N, int MB, int CS,
                                                int nbuf, int kc, int rc,
                                                int kr) {
  Layout L;
  const int item = (int)sizeof(T);
  L.kw = item == 4 ? 8 : 16;
  L.kc = kc;
  L.kpc = kc / L.kw;
  L.rc = rc;
  L.pieces = rc * item / 128;
  L.kr = kr;
  L.kts = 0;
  L.rs = 0;
  L.stages = FWD ? 2 : 8;
  L.rows = FWD ? (MB + 7) / 8 * 8 : (MB + 15) / 16 * 16;
  L.share = L.rows / CS;
  L.mt = FWD ? N / 4 : L.rows / 16;
  L.nt = FWD ? L.rows / 8 : N / 8;
  L.ks = L.mt >= WARPS ? 1 : WARPS / L.mt;
  L.cols = FWD ? 4 * N : N;
  L.ps = FWD ? L.cols + 8 : L.cols;
  L.rank = up1024((size_t)L.pieces * L.share * 128);
  L.slot = CS * L.rank;
  L.wt = (size_t)L.cols * kc * item;
  L.buf = STREAM_BAR_BYTES;
  L.w = L.buf + (size_t)nbuf * L.slot;
  L.res = L.w + (size_t)nbuf * L.wt;
  layout_tail<T, FWD>(L, L.res + (size_t)kr * L.wt, MB, N);
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
// the streamed mode's weight ring and resident chunks
__device__ __forceinline__ unsigned wfull_bar(unsigned bars, int i) {
  return bars + 256 + 8 * i;
}
__device__ __forceinline__ unsigned wempty_bar(unsigned bars, int i) {
  return bars + 320 + 8 * i;
}
__device__ __forceinline__ unsigned res_bar(unsigned bars) {
  return bars + 384;
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

// The streamed mode's consumers are done with a chunk: after they meet,
// warp 0 frees its weight slot (`wbar`, 0 for a resident chunk: one
// arrival in this CTA) and, at a rows chunk's end, its rows slot (`rbar`,
// else 0: one arrival in each of the cluster's CTAs, lane r to rank r), so
// that the rows warps refill it, and the multicasts overwrite it, only
// once every CTA is done
__device__ __forceinline__ void release_chunk(unsigned wbar, unsigned rbar,
                                              int cs, int warp, int lane) {
  consumers_sync();
  if (warp == 0) {
    if (wbar && lane == 0) mbar_arrive_local(wbar);
    if (rbar) {
      if (cs == 1) {
        if (lane == 0) mbar_arrive_local(rbar);
      } else if (lane < cs) {
        mbar_arrive_remote(cluster_addr(rbar, lane));
      }
    }
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

// One tensor-map copy global -> shared (a 5-D box, coordinates innermost
// first) counted in bytes on an mbarrier: into this CTA, or multicast to
// the same offset of every CTA in `mask`
__device__ __forceinline__ void tensor_copy(unsigned dst, const CUtensorMap* map,
                                            const int (&c)[5], unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c[0]), "r"(c[1]),
      "r"(c[2]), "r"(c[3]), "r"(c[4])
      : "memory");
}
__device__ __forceinline__ void tensor_copy_mc(unsigned dst,
                                               const CUtensorMap* map,
                                               const int (&c)[5], unsigned bar,
                                               unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5, %6, %7, %8}], [%2], %3;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask),
      "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4])
      : "memory");
}

// The two tensor maps over one exchanged tensor (kernels' parameters, so
// in the parameter space the copies read them from): `chunk` boxes a CTA's
// share of rows of a whole chunk, dims (128-byte piece, row, piece of a
// segment, segment, step) and box (128 / item, share, pieces, 1, 1), for a
// chunk inside H; `piece` one 128-byte piece, dims (column of a segment,
// row, segment, step), whose columns past H and rows past B read as zeros,
// for the pieces of a chunk that H cuts short. A row holds `segs` segments
// of H values (h: the U units; dgates: the 4U (gate, unit) pairs).
struct RowMaps {
  CUtensorMap chunk, piece;
};

// Rows chunk c's rows of segment `seg` at step `step`: this CTA's share
// (rows r0 + rank * share on) of each 128-byte piece, one tensor copy for
// a chunk inside H, else one a piece, landing at `dst` in [pieces][share]
// [128 bytes] and in the same place of every CTA of the cluster; one
// arrival on `bar` expecting the bytes that all the cluster's copies bring
__device__ __forceinline__ void copy_rows(const RowMaps& maps, const Layout& L,
                                          int H, int item, int c, int seg,
                                          int step, int r0, unsigned rank,
                                          int cs, unsigned dst,
                                          unsigned bar) {
  const unsigned short mask = (unsigned short)((1u << cs) - 1);
  const int row = r0 + (int)rank * L.share, cols = 128 / item;
  const bool whole = (c + 1) * L.rc <= H;
  const int np = whole ? L.pieces : ((H - c * L.rc) * item + 127) / 128;
  mbar_expect(bar, (unsigned)(cs * np * L.share * 128));
  dst += rank * (unsigned)L.rank;
  for (int p = 0; p < (whole ? 1 : np); ++p) {
    const int cw[5] = {0, row, c * L.rc / cols, seg, step};
    const int cp[5] = {c * L.rc + p * cols, row, seg, step, 0};
    const CUtensorMap* map = whole ? &maps.chunk : &maps.piece;
    const unsigned at = dst + p * L.share * 128;
    if (cs > 1)
      tensor_copy_mc(at, map, whole ? cw : cp, bar, mask);
    else
      tensor_copy(at, map, whole ? cw : cp, bar);
  }
}

// A lane's row of a streamed mode's rows slot for ldmatrix (lane l gives
// the address of row l % 8 of matrix l / 8): the row's byte offset in a
// slot (its CTA part, its 128-byte line in the part), and its lines'
// swizzle at piece 0 (128-byte swizzle: 16-byte unit u of a line lies at
// u XOR the line's address bits 7-9; `ring` the rows ring's shared
// address; the parts are 1024-byte aligned)
struct SwzRow {
  unsigned off, sw;
};
__device__ __forceinline__ SwzRow swz_row(const Layout& L, unsigned ring,
                                          int r) {
  return SwzRow{(unsigned)((r / L.share) * L.rank + (r % L.share) * 128),
                ((ring >> 7) + (unsigned)(r % L.share)) & 7};
}
// The shared address of that row's 16-byte unit 2 (j % 4) + `half` of
// k-tile j (32 bytes), in piece p0 + j / 4 of the slot at `slot`
__device__ __forceinline__ unsigned swz_addr(const Layout& L, SwzRow row,
                                             unsigned slot, int p0, int j,
                                             unsigned half) {
  const int p = p0 + (j >> 2);
  const unsigned u =
      (((unsigned)(j & 3) << 1) | half) ^ ((row.sw + (unsigned)(p * L.share)) & 7);
  return slot + row.off + (unsigned)(p * L.share * 128) + (u << 4);
}
// ldmatrix: four (two) 8 x 8 matrices of 16-bit values, lane l giving the
// row address of row l % 8 of matrix l / 8; lane (g, t) gets the 32-bit
// word t of row g of each, which is the mma fragment register of that
// matrix for tf32 (k = t, 4 a row) and bf16 (k = 2t, 2t + 1) alike
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned& r0,
                                        unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
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
// One arrival from each CTA of the cluster (the consumers meet first)
// frees a ring buffer.
__device__ __forceinline__ void grid_init_barriers(unsigned bars, int nbuf,
                                                   int cs) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i) {
      mbar_init_n(full_bar(bars, i), 1);
      mbar_init_n(empty_bar(bars, i), cs);
    }
    mbar_init_n(in_bar(bars, 0), 32);
    mbar_init_n(in_bar(bars, 1), 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}
// The streamed mode's: the rows' ring (`empty`: one arrival from each CTA
// of the cluster), the weight ring (one from this CTA), the resident
// chunks and the inputs
__device__ __forceinline__ void stream_init_barriers(unsigned bars, int nbuf,
                                                     int cs) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i) {
      mbar_init_n(full_bar(bars, i), 1);
      mbar_init_n(empty_bar(bars, i), cs);
      mbar_init_n(wfull_bar(bars, i), 1);
      mbar_init_n(wempty_bar(bars, i), 1);
    }
    mbar_init_n(res_bar(bars), 1);
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
// of `ctas` CTAs of `threads` in clusters of `cs`, all resident at once or
// refused.
int grid_launch(const void* kernel, void* params, int ctas, int cs, int smem,
                void* stream, int threads = THREADS) {
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
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 2 : 1;
  void* args[] = {params};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many CTAs of `kernel` (of `threads`) with `smem` bytes of dynamic
// shared memory the card holds at once in clusters of `cs`
// (cudaOccupancyMaxActiveClusters times cs; for cs = 1 blocks per SM
// times SMs), or minus the CUDA error.
int grid_max_ctas(const void* kernel, int smem, int cs,
                  int threads = THREADS) {
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
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n * cs : -(int)err;
  }
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
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
// unit (the last may own fewer columns); weight chunks of a multiple of
// 128 bytes of depth, rows chunks of whole weight chunks up to 2 KB a row;
// rings of 2-8 slots; any number of resident chunks that `smem` holds
inline bool stream_args_ok(int H, int N, int CS, int MB, int nbuf, int kc,
                           int rc, int kr, int item, int smem, size_t total) {
  return (N == 8 || N == 16 || N == 32 || N == 64) && H % 8 == 0 &&
         (CS == 1 || CS == 2 || CS == 4 || CS == 8) &&
         ((H + N - 1) / N) % CS == 0 && MB >= 1 && MB <= MAX_ROWS &&
         nbuf >= 2 && nbuf <= MAX_BUFS &&
         kc * item % 128 == 0 && kc * item >= 128 && rc % kc == 0 &&
         rc * item <= 2048 && kr >= 0 &&
         (size_t)smem == total;
}

// ---- tensor maps (host) ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken through the runtime (so the
// library links nothing but the runtime), or null
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// Errors of the tensor maps come back as TMAP_ERROR + the encoder's CUresult
constexpr int TMAP_ERROR = 10000;

// A 5-D tensor map of storage type T over `base`: `dim` innermost first,
// `stride` the byte strides of dims 1-4, `box` the box; 128-byte swizzle,
// zeros out of bounds
template <typename T>
int encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dim)[5],
               const cuuint64_t (&stride)[4], const cuuint32_t (&box)[5]) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return TMAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      5, const_cast<void*>(base), dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

// The RowMaps of a tensor at `base` of `steps` steps (at `step_bytes`) of
// B rows (at `row_bytes`), each `segs` segments of H values, for a layout
// L and clusters of CS (boxes of L.share rows)
template <typename T>
int row_maps(RowMaps* m, const void* base, int H, int segs, int B, int steps,
             size_t row_bytes, size_t step_bytes, const Layout& L) {
  const int item = (int)sizeof(T), cols = 128 / item;
  const cuuint64_t seg = (cuuint64_t)H * item, whole = H * item / 128;
  const cuuint64_t cdim[5] = {(cuuint64_t)cols, (cuuint64_t)B,
                              whole ? whole : 1, (cuuint64_t)segs,
                              (cuuint64_t)steps};
  const cuuint64_t cstr[4] = {row_bytes, 128, seg, step_bytes};
  const cuuint32_t cbox[5] = {(cuuint32_t)cols, (cuuint32_t)L.share,
                              (cuuint32_t)L.pieces, 1, 1};
  int err = encode_map<T>(&m->chunk, base, cdim, cstr, cbox);
  if (err) return err;
  const cuuint64_t pdim[5] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)segs,
                              (cuuint64_t)steps, 1};
  const cuuint64_t pstr[4] = {row_bytes, seg, step_bytes,
                              step_bytes * (cuuint64_t)steps};
  const cuuint32_t pbox[5] = {(cuuint32_t)cols, (cuuint32_t)L.share, 1, 1, 1};
  return encode_map<T>(&m->piece, base, pdim, pstr, pbox);
}

}  // namespace
