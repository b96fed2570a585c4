// EC votes: the masked integer scatter-adds of L2 (raw allele counts), L4
// (cis-window consensus votes and insertion aggregates) and the window
// seams, into the int32 accumulators of ec/device_ec.py, with the entries
// that a mask drops counted a block at a time.
//
// Replaces no TPU kernel.  The JAX package (hifiasm_tpu/ec/device_ec.py
// `_raw_counts_scan`, `_cis_votes_scan`, `_seam_add`) aggregates with
// one-hot int8 matmuls and log-shift rolls, which XLA compiles, because
// the TPU scatters slowly.  The port first scattered with PyTorch's
// `index_add_` over [N, XL] int64 index planes built for every
// sub-scatter, and sent each masked entry to the accumulator's one spare
// last slot, so that no scatter needed a host-synchronising compaction.
// Two thirds of all entries are masked (insertions are rare, so the three
// insertion scatters of L4 drop nearly every column), and their atomics
// all landed on that one address per accumulator, where they serialise;
// that took over 80% of the card's busy time in an assembly.
//
// What bounds it on an H100: the atomics of the kept entries (about two
// in five of the entries given, one int32 red.add each, mostly to
// distinct addresses in runs of consecutive columns) and the bytes of the
// uint8 planes read once.  The design:
//  * One warp a window, walking the windows of a grid sized to fill the
//    card once.  The warp loads the window's descriptors (row, start,
//    length, read length, mask) once, as broadcasts, and computes in
//    registers how many leading columns are kept: n = min(xlen, XL,
//    qlen - ws) on a kept window, else 0.  Nothing of [N, XL] is built.
//  * Columns past n are dropped without being read: lane 0 counts
//    (XL - n) per sub-scatter, so a masked window costs five loads.
//  * Lanes take consecutive columns, so the plane loads are coalesced
//    and each accumulator row gets red.adds at consecutive addresses.
//    An atomic is issued only for a kept entry; integer adds commute, so
//    the accumulators are bit-identical whatever the order.
//  * Each dropped entry adds 1 to a register.  At the end a warp
//    reduction (__reduce_add_sync) and a block reduction in shared memory
//    sum the registers, and one 64-bit atomic a block adds the sum to the
//    device counter: one drop per masked entry per sub-scatter, as the
//    spare slots counted them.  The spare slots are left untouched.
//  * The seam form is the plain one-dimensional masked add: acc[idx[j]]
//    += 1 where keep[j], one thread an entry, with the same drop count.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int T = 256;               // threads a block
constexpr int WARPS = T / 32;

// Adds the block's dropped entries (``drop`` of each thread) to
// *dropped with one atomic.  Every thread of the block calls it.
__device__ __forceinline__ void count_drops(unsigned drop,
                                            unsigned long long* dropped) {
  __shared__ unsigned long long part[WARPS];
  const unsigned s = __reduce_add_sync(0xffffffffu, drop);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tot = 0;
    for (int k = 0; k < WARPS; ++k) tot += part[k];
    if (tot) atomicAdd(dropped, tot);
  }
}

// The L2 (CIS false) and L4 (CIS true) votes of N windows of XL columns.
// Column i of window w lies at p = q_row[w] * L + q_ws[w] + i and is kept
// where mask[w], i < xlen[w] and q_ws[w] + i < qlen[w].  L2: votes[c * RL
// + p] += 1 for tb class c < 5.  L4, besides: where ic > 0, ins_tot[p],
// ins_bc[ib * RL + p] (ib < 4) and ins_lc[min(ic, 8) * RL + p] += 1.
template <bool CIS>
__global__ void __launch_bounds__(T) vote_windows_kernel(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ ic,
    const uint8_t* __restrict__ ib, const int64_t* __restrict__ q_row,
    const int64_t* __restrict__ q_ws, const int64_t* __restrict__ xlen,
    const int64_t* __restrict__ qlen, const uint8_t* __restrict__ mask,
    int64_t N, int XL, int64_t L, int64_t RL, int32_t* __restrict__ votes,
    int32_t* __restrict__ ins_tot, int32_t* __restrict__ ins_bc,
    int32_t* __restrict__ ins_lc, unsigned long long* dropped) {
  constexpr unsigned NSUB = CIS ? 4 : 1;   // sub-scatters an entry
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = int64_t(gridDim.x) * WARPS;
  unsigned drop = 0;
  for (int64_t w = int64_t(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       w < N; w += nwarps) {
    int n = 0;
    if (mask[w]) {
      int64_t m = xlen[w] < XL ? xlen[w] : int64_t(XL);
      const int64_t on_read = qlen[w] - q_ws[w];
      m = on_read < m ? on_read : m;
      n = m > 0 ? int(m) : 0;
    }
    if (lane == 0) drop += NSUB * unsigned(XL - n);
    if (n == 0) continue;
    const int64_t base = q_row[w] * L + q_ws[w];
    const int64_t row = w * XL;
    for (int i = lane; i < n; i += 32) {
      const int64_t p = base + i;
      const unsigned c = tb[row + i];
      if (c < 5) atomicAdd(votes + c * RL + p, 1); else ++drop;
      if (CIS) {
        const unsigned k = ic[row + i];
        if (k > 0) {
          const unsigned b = ib[row + i];
          atomicAdd(ins_tot + p, 1);
          if (b < 4) atomicAdd(ins_bc + b * RL + p, 1); else ++drop;
          atomicAdd(ins_lc + (k < 8 ? k : 8u) * RL + p, 1);
        } else {
          drop += 3;
        }
      }
    }
  }
  if (dropped != nullptr) count_drops(drop, dropped);
}

// acc[idx[j]] += 1 where keep[j], for j < n.
__global__ void __launch_bounds__(T) vote_indexed_kernel(
    const int64_t* __restrict__ idx, const uint8_t* __restrict__ keep,
    int64_t n, int32_t* __restrict__ acc, unsigned long long* dropped) {
  unsigned drop = 0;
  const int64_t stride = int64_t(gridDim.x) * T;
  for (int64_t j = int64_t(blockIdx.x) * T + threadIdx.x; j < n;
       j += stride) {
    if (keep[j]) atomicAdd(acc + idx[j], 1); else ++drop;
  }
  if (dropped != nullptr) count_drops(drop, dropped);
}

// Blocks for a launch: as many as fill every SM at the kernel's
// occupancy, and no more than ``need``.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, long long need, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess)
    st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, 0);
  if (st != cudaSuccess) return st;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = need < full ? (need > 0 ? need : 1) : full;
  return cudaSuccess;
}

template <bool CIS>
int launch_windows(const void* tb, const void* ic, const void* ib,
                   const void* q_row, const void* q_ws, const void* xlen,
                   const void* qlen, const void* mask, long long N, int XL,
                   long long L, long long RL, void* votes, void* ins_tot,
                   void* ins_bc, void* ins_lc, void* dropped, void* stream) {
  if (N <= 0) return 0;
  auto kernel = vote_windows_kernel<CIS>;
  long long blocks = 0;
  cudaError_t st = grid_size(kernel, (N + WARPS - 1) / WARPS, &blocks);
  if (st != cudaSuccess) return int(st);
  // a warp's drop count is at most its windows' XL * NSUB entries; the
  // warp reduction is 32-bit
  const long long per_warp = (N + blocks * WARPS - 1) / (blocks * WARPS);
  if (per_warp * XL * (CIS ? 4 : 1) >= (1LL << 32))
    return int(cudaErrorInvalidValue);
  kernel<<<unsigned(blocks), T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(ic),
      static_cast<const uint8_t*>(ib), static_cast<const int64_t*>(q_row),
      static_cast<const int64_t*>(q_ws), static_cast<const int64_t*>(xlen),
      static_cast<const int64_t*>(qlen), static_cast<const uint8_t*>(mask),
      int64_t(N), XL, int64_t(L), int64_t(RL),
      static_cast<int32_t*>(votes), static_cast<int32_t*>(ins_tot),
      static_cast<int32_t*>(ins_bc), static_cast<int32_t*>(ins_lc),
      static_cast<unsigned long long*>(dropped));
  return int(cudaGetLastError());
}

}  // namespace

// L2: cnt [5 * RL + 1] int32 += the raw allele counts of N windows.
// ``dropped`` (one uint64 on the device, or null) += the entries dropped.
extern "C" int vote_raw_counts_launch(
    const void* tb, const void* q_row, const void* q_ws, const void* xlen,
    const void* qlen, const void* mask, long long N, int XL, long long L,
    long long RL, void* cnt, void* dropped, void* stream) {
  return launch_windows<false>(tb, nullptr, nullptr, q_row, q_ws, xlen, qlen,
                               mask, N, XL, L, RL, cnt, nullptr, nullptr,
                               nullptr, dropped, stream);
}

// L4: votes [5 * RL + 1], ins_tot [RL + 1], ins_bc [4 * RL + 1] and
// ins_lc [9 * RL + 1] int32 += the cis-window votes of N windows.
extern "C" int vote_cis_launch(
    const void* tb, const void* ic, const void* ib, const void* q_row,
    const void* q_ws, const void* xlen, const void* qlen, const void* mask,
    long long N, int XL, long long L, long long RL, void* votes,
    void* ins_tot, void* ins_bc, void* ins_lc, void* dropped, void* stream) {
  return launch_windows<true>(tb, ic, ib, q_row, q_ws, xlen, qlen, mask, N,
                              XL, L, RL, votes, ins_tot, ins_bc, ins_lc,
                              dropped, stream);
}

// The one-dimensional form (the seams): acc[idx[j]] += 1 where keep[j].
extern "C" int vote_indexed_launch(const void* idx, const void* keep,
                                   long long n, void* acc, void* dropped,
                                   void* stream) {
  if (n <= 0) return 0;
  long long blocks = 0;
  cudaError_t st = grid_size(vote_indexed_kernel, (n + T - 1) / T, &blocks);
  if (st != cudaSuccess) return int(st);
  if (32 * ((n + blocks * T - 1) / (blocks * T)) >= (1LL << 32))
    return int(cudaErrorInvalidValue);
  vote_indexed_kernel<<<unsigned(blocks), T, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), static_cast<const uint8_t*>(keep),
      int64_t(n), static_cast<int32_t*>(acc),
      static_cast<unsigned long long*>(dropped));
  return int(cudaGetLastError());
}

// Registers a thread, shared memory a block (bytes) and resident blocks
// per SM of the L4 kernel.
extern "C" int vote_scatter_info(int* regs, int* smem_bytes,
                                 int* blocks_per_sm) {
  cudaFuncAttributes a;
  auto kernel = vote_windows_kernel<true>;
  cudaError_t st = cudaFuncGetAttributes(&a, kernel);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       T, 0);
  if (st != cudaSuccess) return int(st);
  *regs = a.numRegs;
  *smem_bytes = int(a.sharedSizeBytes);
  return 0;
}
