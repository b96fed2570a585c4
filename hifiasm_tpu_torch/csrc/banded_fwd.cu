// K2: banded bit-parallel Myers forward scan in scoring mode, one window
// per thread.
//
// Replaces the TPU kernel hifiasm_tpu/ops/banded_pallas.py
// `_pallas_forward` (kernel body `_mk_kernel`).  It computes the err and
// y_end of the host oracle `banded_batch_np(..., traceback=False)`:
//   * band W = 2e+1 <= 63 diagonals: every band plane (VP, VN, Peq[4]) is
//     one native uint64_t in registers, where the TPU kernel carries
//     (hi, lo) uint32 lane pairs across a (1, 512) lane block;
//   * the forward scan over x rows, then the free-end scan over y ends
//     xlen .. min(xlen + 2e, ylen), taking a centre-diagonal end that ties
//     the best; err <= e, else -1.
// There is no move log and no traceback (K1, csrc/banded_tb.cu, runs the
// same forward recurrence and logs it for its traceback).
//
// What bounds it on an H100: integer operations.  Each x row is one
// dependent chain of u64 adds, shifts and logic ops (32-bit pairs in the
// SASS) on registers; the inputs are read once (x one byte per row, y one
// byte per admitted band row), so the bytes moved are small beside the
// instructions.  One thread per window gives every thread an independent
// chain, and the card hides the chain's latency through the number of
// resident warps; nothing is kept in shared or device memory in between.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t pick(uint8_t c, uint64_t p0, uint64_t p1,
                                         uint64_t p2, uint64_t p3) {
  return c == 0 ? p0 : c == 1 ? p1 : c == 2 ? p2 : c == 3 ? p3 : 0ull;
}

__global__ void banded_fwd_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ xlen,
    const uint8_t* __restrict__ y, const int32_t* __restrict__ ylen,
    int64_t B, int XL, int YL, int e, int32_t* __restrict__ err_out,
    int32_t* __restrict__ yn_out) {
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

  // forward scan; y[i + W] enters the band after row i while it exists
  const int yend = (YL < yl ? YL : yl) - W;
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
    p0 >>= 1; p1 >>= 1; p2 >>= 1; p3 >>= 1;
    if (i < yend) {
      const uint8_t c = yb[i + W];
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
  err_out[b] = best_err <= e ? best_err : -1;
  yn_out[b] = best_n;
}

}  // namespace

extern "C" int banded_fwd_launch(
    const void* x, const void* xlen, const void* y, const void* ylen,
    long long B, int XL, int YL, int e, void* err, void* yn, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  banded_fwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const int32_t*)xlen, (const uint8_t*)y,
      (const int32_t*)ylen, (int64_t)B, XL, YL, e, (int32_t*)err,
      (int32_t*)yn);
  return (int)cudaGetLastError();
}
