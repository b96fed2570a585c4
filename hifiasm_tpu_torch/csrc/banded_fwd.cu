// K2: banded bit-parallel Myers forward scan in scoring mode, one window
// per thread.
//
// Replaces the TPU kernel hifiasm_tpu/ops/banded_pallas.py
// `_pallas_forward` (kernel body `_mk_kernel`).  It computes the err and
// y_end of the host oracle `banded_batch_np(..., traceback=False)`: the
// forward scan over x rows, then the free-end scan over y ends
// xlen .. min(xlen + 2e, ylen), taking a centre-diagonal end that ties the
// best; err <= e, else -1.  It is K1's pass A (csrc/banded_tb.cu) without
// the checkpoints: both run `forward_pass` and `free_end` of
// csrc/banded_myers.cuh, the band planes as uint64_t in registers and x
// and y staged through shared memory in 64-row tiles, double-buffered.
//
// What bounds it on an H100: integer operations.  Each x row is one
// dependent chain of u64 adds, shifts and logic ops (32-bit pairs in the
// SASS) on registers; the inputs are read once, so the bytes moved are
// small beside the instructions.  One thread per window gives 2,048 warps
// for 65,536 windows, about 16 an SM, and the card hides the chain's
// latency only through them.  The earlier version read x and y one byte
// per row straight from device memory at a stride of XL, so each warp load
// touched 32 lines, and its per-base select compiled to a branch tree on
// every row; the staged tiles make every global load coalesced and fly
// while the tile before runs, and the match mask is picked with masks.
// The e = 31 build uses 63 registers, no spills, 34,820 B of shared memory
// a block and 6 blocks per SM (`-Xptxas -v`, `banded_fwd_info`; NVIDIA
// H100 80GB HBM3, CUDA 12.8); 512 blocks fill 132 SMs in one wave.

#include "banded_myers.cuh"

namespace {

using namespace banded;

// E > 0 fixes e at compile time (e = 31, the EC band); E = 0 takes e from
// the launch.
template <int E>
__global__ void __launch_bounds__(T) banded_fwd_kernel(
    const uint8_t* __restrict__ x, const int32_t* __restrict__ xlen,
    const uint8_t* __restrict__ y, const int32_t* __restrict__ ylen,
    int64_t B, int XL, int YL, int e_arg, int32_t* __restrict__ err_out,
    int32_t* __restrict__ yn_out) {
  __shared__ __align__(16) uint32_t words[FWD_WORDS];
  __shared__ int s_max;
  const int e = E > 0 ? E : e_arg;
  const int64_t b0 = int64_t(blockIdx.x) * T;
  const int64_t b = b0 + threadIdx.x;
  const bool lane = b < B;
  int xl = lane ? xlen[b] : 0;
  xl = xl < 0 ? 0 : (xl > XL ? XL : xl);
  const int yl = lane ? ylen[b] : 0;
  const int xlmax = block_max(xl, &s_max);

  stage<16>(words, y, YL, 0, b0, B);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  Fwd s = initial_state(words + threadIdx.x * 17, lead(y, YL, 0, b),
                        2 * e + 1, YL, yl);
  __syncthreads();
  int err = 0;
  forward_pass<false>(s, err, words, x, y, XL, YL, e, b0, B, xl, yl, xlmax,
                      nullptr);
  int best_err, best_n;
  free_end(s.vp, s.vn, err, xl, yl, e, best_err, best_n);
  if (lane) {
    err_out[b] = best_err <= e ? best_err : -1;
    yn_out[b] = best_n;
  }
}

}  // namespace

extern "C" int banded_fwd_launch(
    const void* x, const void* xlen, const void* y, const void* ylen,
    long long B, int XL, int YL, int e, void* err, void* yn, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + T - 1) / T;
  auto kernel = e == 31 ? banded_fwd_kernel<31> : banded_fwd_kernel<0>;
  kernel<<<unsigned(blocks), T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(xlen),
      static_cast<const uint8_t*>(y), static_cast<const int32_t*>(ylen),
      int64_t(B), XL, YL, e, static_cast<int32_t*>(err),
      static_cast<int32_t*>(yn));
  return int(cudaGetLastError());
}

// Registers a thread, shared memory a block and resident blocks per SM of
// this build's e = 31 kernel.
extern "C" int banded_fwd_info(int* regs, int* smem_bytes,
                               int* blocks_per_sm) {
  cudaFuncAttributes a;
  auto kernel = banded_fwd_kernel<31>;
  cudaError_t st = cudaFuncGetAttributes(&a, kernel);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, T, 0);
  if (st != cudaSuccess) return int(st);
  *regs = a.numRegs;
  *smem_bytes = int(a.sharedSizeBytes);
  return 0;
}
