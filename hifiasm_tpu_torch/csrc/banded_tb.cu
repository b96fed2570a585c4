// K1: banded bit-parallel Myers alignment with full traceback, one EC
// window per thread, as checkpoints + recompute + a row-synchronous
// backward.
//
// Replaces the TPU kernel hifiasm_tpu/ops/pallas_tb.py `pallas_tb_core`
// (kernel body `_mk_kernel`).  It computes what the host oracle
// hifiasm_tpu/ops/banded_batch.py `banded_batch_np` computes: x aligns
// globally with the y start free in [0, 2e] and the y end free in
// [xlen, xlen + 2e], err <= e else -1, and the traceback from the best end
// prefers diag, then horizontal (insertion), then vertical (deletion)
// moves, one (tb, ic, ib) byte triple per x row.  The forward scan and the
// staged loads are csrc/banded_myers.cuh, shared with K2.
//
// What bounds it on an H100: integer operations, issued by too few warps.
// Each window is one serial chain of u64 logic, adds and shifts (32-bit
// pairs in the SASS) on registers, and a 65,536-window launch is only
// 2,048 warps, about 16 an SM, so the card hides the chain's latency only
// through those few warps; everything that is not the chain has to stay
// off the memory pipes.  The earlier version wrote a 24 B move log per
// row per window to device memory (1.22 GB a launch, in a 1.5 GiB
// scratch), re-read it in a traceback that took one move per step, so
// lanes drifted apart in rows and every warp access touched up to 32
// lines, and left the outputs to be transposed.
//
// The design:
//  * Pass A, the forward scan (banded_myers.cuh `forward_pass`), keeps no
//    log.  Every RC = 16 rows it stores the state (VP, VN and three y
//    planes, 40 B; `Fwd`) to a checkpoint buffer laid out
//    [segment][plane][window] (coalesced; 49 x 40 B per window at
//    XL = 775, 128 MB for 65,536 windows, the kernel's only scratch), then
//    the free-end scan gives err and y_end.
//  * Pass B walks the segments from the last to the first, in lockstep
//    across the block.  It recomputes a segment's RC rows from its
//    checkpoint into shared memory (diag = ~(eq ^ D0), HP, VP' as u64,
//    [row][plane][thread]; each thread reads back only its own column),
//    then takes one backward step per x row for every lane, without a
//    branch: the run of insertions at the row is one count-leading-zeros
//    over the stop bits diag | ~(VP' << 1) at or below the current
//    diagonal, then diag, else vertical, else the lane stalls.  The
//    recompute doubles the forward work; the log's traffic goes.
//  * y is kept as three bit planes of the low three bits of y[i .. i+63]
//    (codes 0..4 are exact), shifted by one row per backward step, so the
//    backward reads no y at a data-dependent offset.
//  * x and y reach shared memory by cp.async in coalesced tiles
//    (banded_myers.cuh `stage`): pass A's tiles are double-buffered, and
//    pass B fetches the next segment's tiles and checkpoint while this
//    segment's backward runs.
//  * A segment's (tb, ic, ib) bytes collect in registers, pass through
//    shared memory over the move planes, and are written straight to the
//    [B, XL] outputs, consecutive threads on consecutive bytes of one
//    window's row: rows past a lane's xlen and the rows of failed lanes
//    get 5/0/0 there, so there is no init pass and no transpose.
//  * Occupancy: shared memory is 16 rows x 24 B of move planes plus three
//    input tiles of 5 words, 444 B a window, 56,832 B of dynamic shared
//    memory for a block of T = 128 windows (pass A's double buffer, 34,816
//    B, fits in the same space); with 16 B static and the 1 KB the card
//    reserves per block, four blocks (512 windows) fit an SM's 228 KB, so
//    65,536 windows (512 blocks) run in one wave on 128 of the 132 SMs.
//    __launch_bounds__(128, 4) caps registers at 128 a thread.  The e = 31
//    build uses 125 registers, no spills, 56,848 B of shared memory a
//    block and 4 blocks per SM (`-Xptxas -v`, and `banded_tb_info` from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor; NVIDIA H100 80GB
//    HBM3, CUDA 12.8).

#include "banded_myers.cuh"

namespace {

using namespace banded;

constexpr int NB = 3;                       // move planes per row
constexpr int SB = RC / 4 + 1;              // words per staged tile row
constexpr int SEG_BYTES = RC * NB * T * 8;  // move planes of a segment
constexpr int TILE_WORDS = T * SB;
constexpr int PASS_A_BYTES = FWD_WORDS * 4;
constexpr int PASS_B_BYTES = SEG_BYTES + 3 * TILE_WORDS * 4;
constexpr int SMEM_BYTES =
    PASS_A_BYTES > PASS_B_BYTES ? PASS_A_BYTES : PASS_B_BYTES;
static_assert(3 * TILE_WORDS * 4 <= SEG_BYTES &&
                  T * (64 / 4 + 1) * 4 <= SEG_BYTES,
              "the output stage and the plane tile fit over the planes");

// E > 0 fixes e at compile time (the EC band, e = 31, so the band masks
// are constants); E = 0 takes e from the launch.
template <int E>
__global__ void __launch_bounds__(T, 4) banded_tb_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ xlen,
    const uint8_t* __restrict__ y, const int32_t* __restrict__ ylen,
    int64_t B, int XL, int YL, int e_arg, uint64_t* __restrict__ ckpt,
    int32_t* __restrict__ err_out, int32_t* __restrict__ ys_out,
    int32_t* __restrict__ yn_out, uint8_t* __restrict__ tb,
    uint8_t* __restrict__ ic, uint8_t* __restrict__ ib) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_max;
  const int t = threadIdx.x;
  const int64_t b0 = int64_t(blockIdx.x) * T;
  const int64_t b = b0 + t;
  const bool lane = b < B;
  const int e = E > 0 ? E : e_arg;
  const int W = 2 * e + 1, E2 = 2 * e;
  const uint64_t mask = (1ull << W) - 1ull, top = 1ull << (W - 1);
  int xl = lane ? xlen[b] : 0;
  xl = xl < 0 ? 0 : (xl > XL ? XL : xl);
  const int yl = lane ? ylen[b] : 0;
  const int xlmax = block_max(xl, &s_max);
  const unsigned shx = lead(x, XL, 0, b), shy = lead(y, YL, 0, b),
                 sha = lead(y, YL, W, b);

  // ---- pass A: forward scan with checkpoints, then the free end ----
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  stage<16>(words, y, YL, 0, b0, B);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  Fwd s = initial_state(words + t * 17, shy, W, YL, yl);
  __syncthreads();
  int err = 0;
  forward_pass<true>(s, err, words, x, y, XL, YL, e, b0, B, xl, yl, xlmax,
                     ckpt);
  int best_err, best_n;
  free_end(s.vp, s.vn, err, xl, yl, e, best_err, best_n);
  const bool ok = best_err <= e;
  if (lane) {
    err_out[b] = ok ? best_err : -1;
    yn_out[b] = best_n;
  }

  // ---- pass B: segments from the last, recompute + backward rows ----
  // The move planes `seg` also hold, after a segment's backward, the
  // staged output rows `ost` [3][T][SB] words.  Tiles: tx = x columns
  // [i0, i0 + RC), ta = y columns [i0 + W, ...) (entering the band), tp =
  // y columns [i0, ...) (the y code planes); the next segment's tiles and
  // checkpoint are fetched during this segment's backward.
  uint64_t* seg = reinterpret_cast<uint64_t*>(smem);
  uint32_t* ost = words;
  uint32_t* tx = reinterpret_cast<uint32_t*>(smem + SEG_BYTES);
  uint32_t* ta = tx + TILE_WORDS;
  uint32_t* tp = ta + TILE_WORDS;
  const int nseg = (xlmax + RC - 1) / RC;
  const int top_row = nseg * RC;
  // y code planes for row top_row: bit p = y[top_row + p]
  stage<16>(words, y, YL, top_row, b0, B);
  if (nseg > 0) {
    const int i0 = (nseg - 1) * RC;
    stage<RC / 4>(tx, x, XL, i0, b0, B);
    stage<RC / 4>(ta, y, YL, i0 + W, b0, B);
    stage<RC / 4>(tp, y, YL, i0, b0, B);
  }
  copy_commit();
  Fwd r{0, 0, 0, 0, 0};
  auto load_ckpt = [&](int sg) {
    const uint64_t* c = ckpt + int64_t(sg) * FWD_PLANES * B + b;
    r = Fwd{c[0], c[B], c[2 * B], c[3 * B], c[4 * B]};
  };
  if (nseg > 0 && (nseg - 1) * RC < xl) load_ckpt(nseg - 1);
  copy_wait<0>();
  __syncthreads();
  uint64_t y0 = 0, y1 = 0, y2 = 0;
  auto shift_in = [&](uint64_t c) {   // base c enters at bit 0
    y0 = (y0 << 1) | (c & 1ull);
    y1 = (y1 << 1) | ((c >> 1) & 1ull);
    y2 = (y2 << 1) | ((c >> 2) & 1ull);
  };
#pragma unroll
  for (int q = 15; q >= 0; --q) {
    const uint32_t w4 = tile_word(words + t * 17, q, shy);
#pragma unroll
    for (int j = 3; j >= 0; --j) shift_in((w4 >> (8 * j)) & 0xffu);
  }
  int bb = ok ? best_n - xl : 0;   // the current diagonal, jj - ii
  bool done = !ok;
  const int yend = (YL < yl ? YL : yl) - W;

  for (int sg = (XL + RC - 1) / RC - 1; sg >= 0; --sg) {
    const int i0 = sg * RC;
    uint32_t wtb[RC / 4], wic[RC / 4], wib[RC / 4];
    if (i0 < xlmax) {
      copy_wait<0>();         // this segment's tiles have landed
      __syncthreads();
      // recompute the segment's move planes (this thread's column only)
      const uint32_t* rx = tx + t * SB;
      const uint32_t* ra = ta + t * SB;
      if (i0 + RC <= xl) {
#pragma unroll
        for (int q = 0; q < RC / 4; ++q) {
          const uint32_t xw = tile_word(rx, q, shx);
          const uint32_t aw = tile_word(ra, q, sha);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = 4 * q + j;
            const Row m = step(r, (xw >> (8 * j)) & 0xffu, mask);
            seg[(k * NB + 0) * T + t] = ~(m.eq ^ m.d0) & mask;
            seg[(k * NB + 1) * T + t] = m.hp;
            seg[(k * NB + 2) * T + t] = r.vp;
            admit(r, (aw >> (8 * j)) & 0xffu, i0 + k < yend, top);
          }
        }
      } else {
        for (int k = 0; k < xl - i0; ++k) {
          const Row m = step(r, tile_byte(rx, k, shx), mask);
          seg[(k * NB + 0) * T + t] = ~(m.eq ^ m.d0) & mask;
          seg[(k * NB + 1) * T + t] = m.hp;
          seg[(k * NB + 2) * T + t] = r.vp;
          admit(r, tile_byte(ra, k, sha), i0 + k < yend, top);
        }
      }
      __syncthreads();        // tx and ta are free
      if (sg > 0) {
        stage<RC / 4>(tx, x, XL, i0 - RC, b0, B);
        stage<RC / 4>(ta, y, YL, i0 - RC + W, b0, B);
      }
      copy_commit();
      // one backward step per row, every lane in lockstep
      const uint32_t* rp = tp + t * SB;
#pragma unroll
      for (int q = RC / 4 - 1; q >= 0; --q) {
        const uint32_t yw = tile_word(rp, q, shy);
        uint32_t vtb = 0, vic = 0, vib = 0;
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int kk = 4 * q + j;
          shift_in((yw >> (8 * j)) & 0xffu);   // the planes describe this row
          // every lane computes the step, without a branch, and keeps it
          // where it is active (row below its xlen, no stall yet)
          const bool act = i0 + kk < xl && !done;
          const uint64_t dg = seg[(kk * NB + 0) * T + t];
          const uint64_t hp = seg[(kk * NB + 1) * T + t];
          const uint64_t vp = seg[(kk * NB + 2) * T + t];
          // insertions run down from bb while no diag and VP' allows one;
          // bit 0 always stops (no insertion below diagonal 0)
          const uint64_t stop =
              (dg | ~(vp << 1) | 1ull) & ((2ull << bb) - 1ull);
          const int bs = 63 - __clzll(stop);
          const bool dtake = (dg >> bs) & 1ull;
          const bool vtake = !dtake && bs < E2 && ((hp >> bs) & 1ull);
          const int n = bb - bs;
          // y codes at offsets bs (diag) and bs + 1 (first insertion)
          const uint32_t c0 = uint32_t(y0 >> bs) & 3u;
          const uint32_t c1 = uint32_t(y1 >> bs) & 3u;
          const uint32_t c2 = uint32_t(y2 >> bs) & 3u;
          const uint32_t otb =
              !act ? 5u
                   : dtake ? (c0 & 1u) | ((c1 & 1u) << 1) | ((c2 & 1u) << 2)
                           : (vtake ? 4u : 5u);
          const uint32_t oic = act ? uint32_t(n) : 0u;
          const uint32_t oib =
              act && n > 0 ? (c0 >> 1) | (c1 & 2u) | ((c2 & 2u) << 1) : 0u;
          done = done || (act && !dtake && !vtake);  // no legal move: stop
          bb = act ? (vtake ? bs + 1 : bs) : bb;
          vtb = (vtb << 8) | otb;
          vic = (vic << 8) | oic;
          vib = (vib << 8) | oib;
        }
        wtb[q] = vtb;
        wic[q] = vic;
        wib[q] = vib;
      }
      __syncthreads();        // tp and the move planes are free
      if (sg > 0) stage<RC / 4>(tp, y, YL, i0 - RC, b0, B);
      copy_commit();
      if (sg > 0 && i0 - RC < xl) load_ckpt(sg - 1);
    } else {
#pragma unroll
      for (int q = 0; q < RC / 4; ++q) {
        wtb[q] = 0x05050505u;
        wic[q] = 0;
        wib[q] = 0;
      }
      __syncthreads();        // the last segment's rows are written
    }
    // write rows [i0, i0 + RC) of the block's windows to [B, XL]: each
    // thread one column, consecutive threads on consecutive bytes
#pragma unroll
    for (int q = 0; q < RC / 4; ++q) {
      ost[t * SB + q] = wtb[q];
      ost[TILE_WORDS + t * SB + q] = wic[q];
      ost[2 * TILE_WORDS + t * SB + q] = wib[q];
    }
    __syncthreads();
    const int k = t % RC;
    if (i0 + k < XL) {
      const unsigned sh = 8 * (k & 3);
      const int rows = B - b0 < T ? int(B - b0) : T;
      const uint32_t* o = ost + (t / RC) * SB + (k >> 2);
      int64_t at = (b0 + t / RC) * XL + i0 + k;
      for (int w = t / RC; w < rows; w += T / RC) {
        tb[at] = uint8_t(o[0] >> sh);
        ic[at] = uint8_t(o[TILE_WORDS] >> sh);
        ib[at] = uint8_t(o[2 * TILE_WORDS] >> sh);
        o += (T / RC) * SB;
        at += int64_t(T / RC) * XL;
      }
    }
  }
  if (lane) ys_out[b] = ok ? bb : -1;
}

}  // namespace

extern "C" int banded_tb_launch(
    const void* x, const void* xlen, const void* y, const void* ylen,
    long long B, int XL, int YL, int e, void* ckpt, void* err, void* ys,
    void* yn, void* tb, void* ic, void* ib, void* stream) {
  if (B <= 0) return 0;
  auto kernel = e == 31 ? banded_tb_kernel<31> : banded_tb_kernel<0>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (st != cudaSuccess) return int(st);
  const long long blocks = (B + T - 1) / T;
  kernel<<<unsigned(blocks), T, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(xlen),
      static_cast<const uint8_t*>(y), static_cast<const int32_t*>(ylen),
      int64_t(B), XL, YL, e, static_cast<uint64_t*>(ckpt),
      static_cast<int32_t*>(err), static_cast<int32_t*>(ys),
      static_cast<int32_t*>(yn), static_cast<uint8_t*>(tb),
      static_cast<uint8_t*>(ic), static_cast<uint8_t*>(ib));
  return int(cudaGetLastError());
}

// Bytes of the checkpoint buffer a launch of B windows of XL rows needs:
// [ceil(XL / RC)][FWD_PLANES][B] uint64.
extern "C" long long banded_tb_ckpt_bytes(int XL, long long B) {
  return (long long)((XL + RC - 1) / RC) * FWD_PLANES * B * 8;
}

// Registers a thread, shared memory a block (static + dynamic) and
// resident blocks per SM of this build's e = 31 kernel.
extern "C" int banded_tb_info(int* regs, int* smem_bytes,
                              int* blocks_per_sm) {
  cudaFuncAttributes a;
  auto kernel = banded_tb_kernel<31>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (st == cudaSuccess) st = cudaFuncGetAttributes(&a, kernel);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, T, SMEM_BYTES);
  if (st != cudaSuccess) return int(st);
  *regs = a.numRegs;
  *smem_bytes = int(a.sharedSizeBytes) + SMEM_BYTES;
  return 0;
}
