"""Peaks of the card and the work of the port's kernels, counted from
the shapes of their calls.  A kernel's roofline share is the least time
the card could take for that work (the larger of operations over the
integer peak and bytes over the memory bandwidth) over the kernel's
device time.  The counts follow the algorithm, not a build of it: a
rewritten kernel is held to the same yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM5: 132 SMs at a boost clock of 1,980 MHz (NVIDIA H100
# Tensor Core GPU data sheet: 67 TFLOP/s FP32 = 132 x 128 FMA lanes x 2 x
# 1.98 GHz; 3.35 TB/s HBM3).  Integer peak: 64 results per SM per clock
# for 32-bit add, logic and shift at compute capability 9.0 (CUDA C++
# Programming Guide, "Arithmetic Instructions" throughput table), so
# 132 x 64 x 1.98e9.  Both assume the 700 W power limit.
PEAKS = {
    "int32_ops_per_s": 132 * 64 * 1.98e9,
    "hbm_bytes_per_s": 3.35e12,
}

# K1 (banded_tb: bit-parallel banded edit distance with traceback) on
# EC windows: hifiasm's WINDOW_HC of 775 query bases against 775 + 2e
# target bases, band e = 31 (THRESHOLD_MAX_SIZE), one 64-bit word a row.
K1_XL = 775
K1_E = 31
# 32-bit operations of one DP row of the forward recurrence (Myers 1999
# as banded by Hyyro 2003), counted as 64-bit word operations x 2 with
# three-input logic fused as the hardware's LOP3 allows: the match mask
# of the row's base (2), X (1), D0 (add 1 + logic 3), HN (1), HP (1), the
# shift of D0 (1), VN (1), VP (1), and the shift of the band's target
# planes (3): 15 word operations.  The traceback is not counted.
K1_OPS_PER_ROW = 2 * 15


def k1_work(windows: int, xl: int = K1_XL, e: int = K1_E) -> dict:
    """K1's operations and bytes for ``windows`` windows: every row of
    the forward recurrence once; x (xl), y (xl + 2e), both lengths
    (int32) read once; err, y_start, y_end (int32) and the tb, ic, ib
    planes (xl bytes each) written once."""
    ops = windows * xl * K1_OPS_PER_ROW
    nbytes = windows * (xl + (xl + 2 * e) + 2 * 4 + 3 * 4 + 3 * xl)
    return {"ops": ops, "bytes": nbytes}


def bound_s(work: dict) -> tuple:
    """(least seconds, which peak binds) for ``work``."""
    t_ops = work["ops"] / PEAKS["int32_ops_per_s"]
    t_mem = work["bytes"] / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "int32 operations") if t_ops >= t_mem else \
        (t_mem, "HBM bytes")
