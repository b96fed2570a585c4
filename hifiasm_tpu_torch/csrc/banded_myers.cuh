// The banded bit-parallel Myers forward scan shared by K1 (banded_tb.cu)
// and K2 (banded_fwd.cu): one EC window per thread, a block of T windows,
// x and y staged through shared memory in row tiles.
//
// Band W = 2e+1 <= 63 diagonals, so every band plane (VP, VN and the y
// planes that give each row's match mask) is one uint64_t in registers.  x
// aligns globally against y with the y start free in [0, 2e]; after the
// forward scan the free-end scan picks the y end in [xlen, xlen + 2e]
// (preferring the centre diagonal on a tie), as the host oracle
// hifiasm_tpu/ops/banded_batch.py `banded_batch_np` does.
//
// Staged inputs: x is [B, XL] and y [B, YL] uint8, one window per row, so
// a thread that read its own bytes row by row would make every warp load
// touch 32 lines at a stride of XL.  `stage` copies a tile of columns of
// the block's T rows into shared memory instead, with cp.async (so every
// copy of a tile is in flight at once, and the forward pass's next tile
// flies while this one runs), consecutive threads on consecutive aligned
// words of one row; each thread then reads its own row four columns at a
// time, shifted into place.  A tile row of NW + 1 words (odd) holds 4 NW
// columns at any alignment, so the 32 threads of a warp reading word k of
// their own rows hit 32 different banks.  y is read up to column
// XL + 2e - 1 only, so YL >= XL + 2e is required of the caller.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace banded {

constexpr int T = 128;   // windows, and threads, per block
constexpr int R = 64;    // x rows per staged tile of the forward pass
constexpr int RC = 16;   // rows per checkpoint segment (K1); divides R

// The forward state of one window before a row: VP, VN and the y bases
// in the band as three planes: bit b of y0 and y1 holds bit 0 and bit 1 of
// the base b columns ahead, v is set where that base is admitted (it
// exists: below ylen and YL) and is one of 0..3.  The match mask of x
// base c is then v & ~(y0 ^ c0) & ~(y1 ^ c1), with c0, c1 c's bits spread
// over the word: three planes to shift and fill per row, not the four
// per-base masks of the host oracle.
struct Fwd {
  uint64_t vp, vn, y0, y1, v;
};
constexpr int FWD_PLANES = 5;   // u64 words of a checkpoint

// One row's planes: the match mask of x[i], D0 and HP.
struct Row {
  uint64_t eq, d0, hp;
};

// Asynchronous copy of one aligned word to shared memory (cp.async), or of
// zeros without a read when !valid.
__device__ __forceinline__ void copy_word(uint32_t* dst, const void* src,
                                          bool valid) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying the aligned words that hold columns [col0, col0 + 4 NW)
// of the block's T rows (windows b0 .. b0 + T - 1) of the [B, rowlen]
// uint8 array src: word k = 0 .. NW of row t, counted from the word that
// holds column col0, lands in dst[t * (NW + 1) + k].  Words that hold no
// byte of the row, and rows past B, are zero-filled without a read, so
// no read leaves a row's words.  The reader shifts by the columns' offset
// in their first word (`lead`).  Call from every thread of the block; the
// copies land after copy_commit(), copy_wait() and __syncthreads().
template <int NW>
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const uint8_t* __restrict__ src,
                                      int rowlen, int col0, int64_t b0,
                                      int64_t B) {
  constexpr int S = NW + 1;
  // the block's rows are one span of T * rowlen bytes, so word indices
  // from the aligned word at its start fit 32 bits
  const uint8_t* base = src + b0 * rowlen;
  const unsigned a0 = unsigned(reinterpret_cast<uintptr_t>(base) & 3);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(base - a0);
  const int rows = B - b0 < T ? int(B - b0) : T;
  // thread t copies words t, t + T, ... of the T * S; (w, k) walks them
  int w = threadIdx.x / S, k = threadIdx.x % S;
#pragma unroll 1
  for (int n = 0; n < S; ++n) {
    const unsigned q = ((a0 + unsigned(w * rowlen + col0)) >> 2) + k;
    const unsigned last = (a0 + unsigned((w + 1) * rowlen) - 1) >> 2;
    const bool ok = w < rows && q <= last;
    copy_word(dst + w * S + k, words + (ok ? q : 0u), ok);
    w += T / S;
    k += T % S;
    if (k >= S) {
      k -= S;
      ++w;
    }
  }
}

// The bit shift that aligns column col0 of window b's row in its staged
// words (equal for every col0 of one residue mod 4).
__device__ __forceinline__ unsigned lead(const uint8_t* src, int rowlen,
                                         int col0, int64_t b) {
  return unsigned(reinterpret_cast<uintptr_t>(src + b * rowlen + col0) & 3) *
         8u;
}

// Columns 4q .. 4q + 3 of a staged row (NW + 1 words at `row`).
__device__ __forceinline__ uint32_t tile_word(const uint32_t* row, int q,
                                              unsigned sh) {
  return __funnelshift_r(row[q], row[q + 1], sh);
}

// Column k of a staged row.
__device__ __forceinline__ uint32_t tile_byte(const uint32_t* row, int k,
                                              unsigned sh) {
  return (tile_word(row, k >> 2, sh) >> (8 * (k & 3))) & 0xffu;
}

// Match mask of x code c (0 for c >= 4), with masks and no branch: a
// select over per-base masks compiles to a branch tree on c, and the
// lanes of a warp, holding different bases, would take every branch one
// after another on every row.
__device__ __forceinline__ uint64_t pick(const Fwd& s, uint32_t c) {
  const uint64_t m0 = 0ull - uint64_t(c & 1u);
  const uint64_t m1 = 0ull - uint64_t((c >> 1) & 1u);
  const uint64_t mv = 0ull - uint64_t(c < 4u);
  return s.v & ~(s.y0 ^ m0) & ~(s.y1 ^ m1) & mv;
}

// The y planes before row 0: bases y[p] for p < min(W, ylen, YL).  yrow
// holds this thread's staged y columns [0, 64).
__device__ __forceinline__ Fwd initial_state(const uint32_t* yrow,
                                             unsigned sh, int W, int YL,
                                             int yl) {
  Fwd s{0, 0, 0, 0, 0};
  int w0 = W < YL ? W : YL;
  w0 = w0 < yl ? w0 : yl;
  for (int p = 0; p < w0; ++p) {
    const uint64_t c = tile_byte(yrow, p, sh);
    s.y0 |= (c & 1ull) << p;
    s.y1 |= ((c >> 1) & 1ull) << p;
    s.v |= uint64_t(c < 4) << p;
  }
  return s;
}

// One Myers row against x code xc: updates VP and VN, returns the row's
// planes.
__device__ __forceinline__ Row step(Fwd& s, uint32_t xc, uint64_t mask) {
  const uint64_t eq = pick(s, xc);
  const uint64_t X = eq | s.vn;
  const uint64_t D0 = (((s.vp + (X & s.vp)) & mask) ^ s.vp) | X;
  const uint64_t HN = s.vp & D0;
  const uint64_t HP = s.vn | (~(s.vp | D0) & mask);
  const uint64_t X2 = D0 >> 1;
  s.vn = X2 & HP;
  s.vp = (HN | (~(X2 | HP) & mask)) & mask;
  return Row{eq, D0, HP};
}

// Moves the y planes one row along y, admitting base yc at the band's top
// bit when adm (y[i + W] exists: i + W < min(YL, ylen)).
__device__ __forceinline__ void admit(Fwd& s, uint32_t yc, bool adm,
                                      uint64_t top) {
  s.y0 = (s.y0 >> 1) | ((yc & 1u) ? top : 0ull);
  s.y1 = (s.y1 >> 1) | ((yc & 2u) ? top : 0ull);
  s.v = (s.v >> 1) | (adm && yc < 4u ? top : 0ull);
}

// Words of one staged forward tile row (R columns at any alignment) and
// of the four tiles of the forward pass's double buffer (x and y, twice).
constexpr int FWD_S = R / 4 + 1;
constexpr int FWD_WORDS = 4 * T * FWD_S;

// Starts staging forward tile t0: x columns [t0, t0 + R) and y columns
// [t0 + W, t0 + W + R) (the bases that enter the band) into buf.
__device__ __forceinline__ void stage_fwd(uint32_t* buf,
                                          const uint8_t* __restrict__ x,
                                          const uint8_t* __restrict__ y,
                                          int XL, int YL, int W, int t0,
                                          int64_t b0, int64_t B) {
  stage<R / 4>(buf, x, XL, t0, b0, B);
  stage<R / 4>(buf + T * FWD_S, y, YL, t0 + W, b0, B);
}

// The forward scan of the block's windows over rows [0, xlmax), the
// block's longest x, in tiles of R rows, double-buffered in buf
// (FWD_WORDS): the next tile's copies fly while this one's rows run.
// This thread runs rows [0, xl) and leaves its state after row xl - 1 in
// s and its D0 misses in err.  With CKPT it stores its state before every
// RC-th row i < xl to ckpt[i / RC][plane][b] (FWD_PLANES planes), so a
// warp's stores coalesce.
template <bool CKPT>
__device__ __forceinline__ void forward_pass(
    Fwd& s, int& err, uint32_t* buf, const uint8_t* __restrict__ x,
    const uint8_t* __restrict__ y, int XL, int YL, int e, int64_t b0,
    int64_t B, int xl, int yl, int xlmax, uint64_t* __restrict__ ckpt) {
  constexpr int S = FWD_S;
  const int W = 2 * e + 1;
  const uint64_t mask = (1ull << W) - 1ull, top = 1ull << (W - 1);
  const int yend = (YL < yl ? YL : yl) - W;
  const int64_t b = b0 + threadIdx.x;
  const unsigned shx = lead(x, XL, 0, b), shy = lead(y, YL, W, b);
  if (xlmax > 0) stage_fwd(buf, x, y, XL, YL, W, 0, b0, B);
  copy_commit();
  int cur = 0;
  for (int t0 = 0; t0 < xlmax; t0 += R, cur ^= 1) {
    if (t0 + R < xlmax)
      stage_fwd(buf + (cur ^ 1) * 2 * T * S, x, y, XL, YL, W, t0 + R, b0,
                B);
    copy_commit();
    copy_wait<1>();           // this tile's copies have landed
    __syncthreads();
    const uint32_t* rx = buf + cur * 2 * T * S + threadIdx.x * S;
    const uint32_t* ry = rx + T * S;
#pragma unroll 1
    for (int sub = 0; sub < R / RC; ++sub) {
      const int i0 = t0 + sub * RC;
      if (i0 >= xl) break;
      if (CKPT) {
        uint64_t* c = ckpt + int64_t(i0 / RC) * FWD_PLANES * B + b;
        c[0] = s.vp;
        c[B] = s.vn;
        c[2 * B] = s.y0;
        c[3 * B] = s.y1;
        c[4 * B] = s.v;
      }
      const int q0 = sub * (RC / 4);
      if (i0 + RC <= xl) {
        uint32_t wx[RC / 4 + 1], wy[RC / 4 + 1];
#pragma unroll
        for (int q = 0; q <= RC / 4; ++q) {
          wx[q] = rx[q0 + q];
          wy[q] = ry[q0 + q];
        }
#pragma unroll
        for (int q = 0; q < RC / 4; ++q) {
          const uint32_t xw = __funnelshift_r(wx[q], wx[q + 1], shx);
          const uint32_t yw = __funnelshift_r(wy[q], wy[q + 1], shy);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Row r = step(s, (xw >> (8 * j)) & 0xffu, mask);
            err += 1 - int(r.d0 & 1ull);
            admit(s, (yw >> (8 * j)) & 0xffu, i0 + 4 * q + j < yend, top);
          }
        }
      } else {
        for (int k = 0; k < xl - i0; ++k) {
          const Row r = step(s, tile_byte(rx, 4 * q0 + k, shx), mask);
          err += 1 - int(r.d0 & 1ull);
          admit(s, tile_byte(ry, 4 * q0 + k, shy), i0 + k < yend, top);
        }
      }
    }
    __syncthreads();          // the buffer is free for the tile after next
  }
}

// The free-end scan over y ends xl .. min(xl + 2e, yl) from the state
// after the last row: the end with the fewest errors, the first on a tie,
// then the centre diagonal xl + e if it ties the best.
__device__ __forceinline__ void free_end(uint64_t vp, uint64_t vn, int err,
                                         int xl, int yl, int e,
                                         int& best_err, int& best_n) {
  const int E2 = 2 * e;
  best_err = err;
  best_n = xl;
  int e2 = err;
  const int nb_max = E2 < yl - xl ? E2 : yl - xl;
  for (int b0 = 0; b0 < E2; ++b0) {
    e2 += int((vp >> b0) & 1ull) - int((vn >> b0) & 1ull);
    if (b0 < nb_max && e2 < best_err) {
      best_err = e2;
      best_n = xl + b0 + 1;
    }
  }
  const uint64_t low = (1ull << e) - 1ull;
  const int e3 = err + __popcll(vp & low) - __popcll(vn & low);
  if (yl - xl >= e && e3 == best_err) best_n = xl + e;
}

// The block's longest x (every thread gets it).
__device__ __forceinline__ int block_max(int v, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(slot, v);
  __syncthreads();
  return *slot;
}

}  // namespace banded
