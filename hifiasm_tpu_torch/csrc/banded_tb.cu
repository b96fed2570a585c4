// K1: banded bit-parallel Myers alignment with full traceback, one EC
// window per thread.
//
// Replaces the TPU kernel hifiasm_tpu/ops/pallas_tb.py `pallas_tb_core`
// (kernel body `_mk_kernel`).  It computes the same function as the host
// oracle hifiasm_tpu/ops/banded_batch.py `banded_batch_np`:
//   * band W = 2e+1 <= 63 diagonals: every band plane (VP, VN, Peq[4]) is
//     one native uint64_t, so the TPU's (hi, lo) uint32 lane pairs, its
//     4-per-u32 byte packing and its y bit planes have no counterpart here;
//   * x aligns globally, the y start is free in [0, 2e], the y end is free
//     in [xlen, xlen + 2e]; err <= e, else -1;
//   * traceback from the best end, preferring diag, then horizontal
//     (insertion), then vertical (deletion) moves, one tb byte per x row.
//
// What bounds it on an H100: integer operations.  In the sm_90a SASS the
// forward loop issues 44-71 integer ALU instructions per x row (u64 adds
// and shifts as 32-bit pairs, the Peq select chain, address arithmetic),
// and the traceback 33-52 per move; the band state lives in registers.  One thread per window gives every thread an
// independent serial chain, so the card hides the dependency latency only
// through the number of resident warps.  The forward pass writes three
// u64 move planes per row (D0, HP, VP) to a global log laid out
// [row][plane][window], so a warp's stores coalesce; the backward pass
// re-reads its own rows from that log (24 B per row per window).  The TPU
// kernel checkpoints every 64 rows and recomputes segments to keep the log
// out of HBM; this first version keeps the whole log in device memory
// instead, and a later version can stage it in shared memory.
//
// Outputs tb/ic/ib are written row-major [XL][B] (coalesced); the wrapper
// (hifiasm_tpu_torch/ops/banded_tb.py) transposes them to [B, XL].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t pick(uint8_t c, uint64_t p0, uint64_t p1,
                                         uint64_t p2, uint64_t p3) {
  return c == 0 ? p0 : c == 1 ? p1 : c == 2 ? p2 : c == 3 ? p3 : 0ull;
}

__global__ void banded_tb_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ xlen,
    const uint8_t* __restrict__ y, const int32_t* __restrict__ ylen,
    int64_t B, int XL, int YL, int e,
    unsigned long long* __restrict__ mlog,
    int32_t* __restrict__ err_out, int32_t* __restrict__ ys_out,
    int32_t* __restrict__ yn_out, uint8_t* __restrict__ tb,
    uint8_t* __restrict__ ic, uint8_t* __restrict__ ib) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = 2 * e + 1;
  const int E2 = 2 * e;
  const uint64_t mask = (1ull << W) - 1ull;
  const uint64_t top = 1ull << (W - 1);
  const uint8_t* xb = x + b * XL;
  const uint8_t* yb = y + b * YL;
  int xl = xlen[b];
  xl = xl < 0 ? 0 : (xl > XL ? XL : xl);
  const int yl = ylen[b];

  // Peq: band-relative match masks for y[0 .. min(W, ylen))
  uint64_t p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  const int w0 = W < YL ? W : YL;
  for (int p = 0; p < w0; ++p) {
    if (p >= yl) break;
    const uint8_t c = yb[p];
    const uint64_t bit = 1ull << p;
    p0 |= c == 0 ? bit : 0ull;
    p1 |= c == 1 ? bit : 0ull;
    p2 |= c == 2 ? bit : 0ull;
    p3 |= c == 3 ? bit : 0ull;
  }

  // forward scan, logging (D0, HP, VP') per row
  uint64_t VP = 0, VN = 0;
  int err = 0;
  for (int i = 0; i < xl; ++i) {
    const uint64_t X = pick(xb[i], p0, p1, p2, p3) | VN;
    const uint64_t D0 = (((VP + (X & VP)) & mask) ^ VP) | X;
    const uint64_t HN = VP & D0;
    const uint64_t HP = VN | (~(VP | D0) & mask);
    const uint64_t X2 = D0 >> 1;
    VN = X2 & HP;
    VP = (HN | (~(X2 | HP) & mask)) & mask;
    err += 1 - (int)(D0 & 1ull);
    unsigned long long* row = mlog + (int64_t)i * 3 * B + b;
    row[0] = D0;
    row[B] = HP;
    row[2 * B] = VP;
    p0 >>= 1; p1 >>= 1; p2 >>= 1; p3 >>= 1;
    const int nb = i + W;
    if (nb < YL && nb < yl) {
      const uint8_t c = yb[nb];
      p0 |= c == 0 ? top : 0ull;
      p1 |= c == 1 ? top : 0ull;
      p2 |= c == 2 ? top : 0ull;
      p3 |= c == 3 ? top : 0ull;
    }
  }

  // free-end scan over y endpoints xlen .. min(xlen + 2e, ylen)
  int best_err = err, best_n = xl, e2 = err;
  const int nb_max = E2 < yl - xl ? E2 : yl - xl;
  for (int b0 = 0; b0 < E2; ++b0) {
    e2 += (int)((VP >> b0) & 1ull) - (int)((VN >> b0) & 1ull);
    if (b0 < nb_max && e2 < best_err) {
      best_err = e2;
      best_n = xl + b0 + 1;
    }
  }
  // ungap preference: a centre-diagonal end that ties the best ends there
  int e3 = err;
  for (int b0 = 0; b0 < e; ++b0)
    e3 += (int)((VP >> b0) & 1ull) - (int)((VN >> b0) & 1ull);
  if (yl - xl >= e && e3 == best_err) best_n = xl + e;
  const bool ok = best_err <= e;
  err_out[b] = ok ? best_err : -1;
  yn_out[b] = best_n;

  for (int i = 0; i < XL; ++i) {
    tb[(int64_t)i * B + b] = 5;
    ic[(int64_t)i * B + b] = 0;
    ib[(int64_t)i * B + b] = 0;
  }

  // traceback: diag, else horizontal (insertion), else vertical (deletion)
  int ii = ok ? xl : 0;
  int jj = ok ? best_n : 0;
  while (ii > 0) {
    const int bb = jj - ii;
    const unsigned long long* row = mlog + (int64_t)(ii - 1) * 3 * B + b;
    const uint64_t d0 = row[0], hp = row[B], vp = row[2 * B];
    const bool in_band = bb >= 0 && bb <= E2;
    const int bbs = bb < 0 ? 0 : (bb > E2 ? E2 : bb);
    const uint8_t xc = xb[ii - 1];
    const int jc = jj - 1 < 0 ? 0 : (jj - 1 > YL - 1 ? YL - 1 : jj - 1);
    const uint8_t yc = yb[jc];
    const bool matches = xc == yc && xc < 4 && jj - 1 < yl && jj >= 1;
    const bool d0bit = (d0 >> bbs) & 1ull;
    const int vpb = bb - 1 < 0 ? 0 : (bb - 1 > E2 ? E2 : bb - 1);
    const int64_t o = (int64_t)(ii - 1) * B + b;
    if (in_band && jj >= 1 && jj - 1 >= ii - 1 && matches == d0bit) {
      tb[o] = yc;
      --ii;
      --jj;
    } else if (jj - 1 >= ii && bb - 1 >= 0 && ((vp >> vpb) & 1ull)) {
      const int n = ic[o] + 1;
      ic[o] = (uint8_t)(n > 255 ? 255 : n);
      ib[o] = yc;
      --jj;
    } else if (in_band && jj <= ii - 1 + E2 && ((hp >> bbs) & 1ull)) {
      tb[o] = 4;
      --ii;
    } else {
      break;          // no legal move: the lane stops where it stands
    }
  }
  ys_out[b] = ok ? jj - ii : -1;
}

}  // namespace

extern "C" int banded_tb_launch(
    const void* x, const void* xlen, const void* y, const void* ylen,
    long long B, int XL, int YL, int e, void* mlog, void* err, void* ys,
    void* yn, void* tb, void* ic, void* ib, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  banded_tb_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)xlen, (const uint8_t*)y,
      (const int32_t*)ylen, (int64_t)B, XL, YL, e,
      (unsigned long long*)mlog, (int32_t*)err, (int32_t*)ys,
      (int32_t*)yn, (uint8_t*)tb, (uint8_t*)ic, (uint8_t*)ib);
  return (int)cudaGetLastError();
}
