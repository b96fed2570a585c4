"""Packed read store and homopolymer compression.

TPU-native re-design of the reference's ``All_reads R_INF`` (Process_Read.h:
115-148): 2-bit-packed sequences in one flat buffer with per-read offsets,
names, N-site lists, and per-read trio flags. Unlike the reference, overlap
vectors live in separate columnar arrays (see overlap/ecpipe.py) so they can
be moved to/from device wholesale.

Base coding follows seq_nt4_table: A=0 C=1 G=2 T=3, N(ambiguous)=4. N sites
are stored out-of-band and the packed base is 0, like ``ha_compress_base``
(Process_Read.cpp:792).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c + 32] = _i  # lowercase

_NT_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_codes(seq: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, N=4)."""
    return _NT4[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> bytes:
    return _NT_CHAR[codes].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (N stays N)."""
    rc = codes[::-1].copy()
    isn = rc == 4
    rc = (3 - rc) & 3
    rc[isn] = 4
    return rc


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Codes (N already zeroed) -> 2-bit packed uint8, 4 bases/byte (LSB first)."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes & 3, np.zeros(pad, dtype=np.uint8)])
    c = c.reshape(-1, 4).astype(np.uint8)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    b = packed[: (n + 3) // 4]
    out = np.empty(((n + 3) // 4, 4), dtype=np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return out.reshape(-1)[:n]


def hpc_compress(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Homopolymer-compress a code sequence.

    Returns (comp_codes, raw_end, run_len): one entry per homopolymer run;
    ``raw_end[j]`` is the raw index of the run's last base (the reference puts
    the minimizer ``pos`` at the run end, sketch.cpp:486), ``run_len[j]`` the
    run length. N bases form their own runs (code 4) so callers can split.
    """
    n = len(codes)
    if n == 0:
        e = np.zeros(0, dtype=np.int64)
        return codes.copy(), e, e
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    np.not_equal(codes[1:], codes[:-1], out=new_run[1:])
    starts = np.flatnonzero(new_run)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = n - 1
    return codes[starts], ends.astype(np.int64), (ends - starts + 1).astype(np.int64)


class ReadStore:
    """Flat packed store of all reads (the ``R_INF`` analog)."""

    def __init__(self):
        self.names: List[str] = []
        self.lens = np.zeros(0, dtype=np.int64)
        self.offsets = np.zeros(1, dtype=np.int64)      # into packed buffer, in bases
        self._packed = np.zeros(0, dtype=np.uint8)
        self._n_sites: List[np.ndarray] = []            # per-read N positions
        self.trio_flags: Optional[np.ndarray] = None

    # ---- construction ----
    @classmethod
    def from_files(cls, paths: Iterable[str], adapter_len: int = 0,
                   min_len: int = 0, min_mean_q: int = 0) -> "ReadStore":
        """adapter_len: clip that many bases off both read ends (-z).
        min_len / min_mean_q: ONT-mode read filters (--rl-cut /
        --sc-cut; the quality gate applies only to FASTQ records)."""
        rs = cls()
        packed_chunks = []
        offsets = [0]
        total = 0
        n_flt = 0
        for path in paths:
            for name, seq, qual in _iter_all_q(path):
                if min_len > 0 and len(seq) < min_len:
                    n_flt += 1
                    continue
                if min_mean_q > 0 and qual:
                    qv = np.frombuffer(qual, np.uint8)
                    if len(qv) and float(qv.mean()) - 33.0 < min_mean_q:
                        n_flt += 1
                        continue
                codes = seq_to_codes(seq)
                if adapter_len > 0 and len(codes) > 2 * adapter_len:
                    codes = codes[adapter_len:-adapter_len]
                nsites = np.flatnonzero(codes == 4)
                c = codes.copy()
                c[nsites] = 0
                packed_chunks.append(pack_2bit(c))
                rs.names.append(name)
                rs._n_sites.append(nsites.astype(np.int64))
                total += len(codes)
                offsets.append(total)
        rs.offsets = np.asarray(offsets, dtype=np.int64)
        rs.lens = np.diff(rs.offsets)
        rs._packed_list = packed_chunks  # per-read packed (4-base aligned)
        rs.trio_flags = np.zeros(len(rs.names), dtype=np.uint8)  # AMBIGU=0
        if n_flt:
            from hifiasm_tpu_torch.utils.logging import log
            log("ReadStore.from_files",
                f"filtered {n_flt} reads (--rl-cut/--sc-cut)")
        return rs

    @classmethod
    def from_arrays(cls, names: List[str], seqs: List[np.ndarray]) -> "ReadStore":
        rs = cls()
        offsets = [0]
        total = 0
        rs._packed_list = []
        for name, codes in zip(names, seqs):
            nsites = np.flatnonzero(codes == 4)
            c = codes.copy()
            c[nsites] = 0
            rs._packed_list.append(pack_2bit(c))
            rs.names.append(name)
            rs._n_sites.append(nsites.astype(np.int64))
            total += len(codes)
            offsets.append(total)
        rs.offsets = np.asarray(offsets, dtype=np.int64)
        rs.lens = np.diff(rs.offsets)
        rs.trio_flags = np.zeros(len(rs.names), dtype=np.uint8)
        return rs

    # ---- access ----
    @property
    def n_reads(self) -> int:
        return len(self.names)

    @property
    def total_bases(self) -> int:
        return int(self.offsets[-1])

    def flat_codes(self) -> np.ndarray:
        """Whole-store decoded code bank (one flat uint8 array; index
        base j of read rid at ``offsets[rid] + j``). Cached; invalidated
        by set_codes. Callers must not mutate the returned array."""
        cached = getattr(self, "_flat", None)
        ver = getattr(self, "_version", 0)
        if cached is not None and cached[1] == ver:
            return cached[0]
        n = self.n_reads
        flat = (np.concatenate([self.get_codes(r) for r in range(n)])
                if n else np.zeros(0, np.uint8))
        flat.flags.writeable = False
        self._flat = (flat, ver)
        return flat

    def get_codes(self, rid: int) -> np.ndarray:
        """Recover a read's codes (with N=4 restored) ~ recover_UC_Read.

        Decoded reads are memoized (invalidated by set_codes): rounds of
        EC / indexing re-read every sequence, and re-unpacking dominates
        the python-side cost of those passes. Callers must not mutate
        the returned array.
        """
        cache = getattr(self, "_decoded", None)
        if cache is None:
            cache = self._decoded = {}
        hit = cache.get(rid)
        if hit is not None:
            return hit
        codes = unpack_2bit(self._packed_list[rid], int(self.lens[rid]))
        ns = self._n_sites[rid]
        if len(ns):
            codes[ns] = 4
        codes.flags.writeable = False
        cache[rid] = codes
        return codes

    def set_codes(self, rid: int, codes: np.ndarray) -> None:
        """Replace a read's sequence (used by EC write-back, ~sl_ec_r)."""
        cache = getattr(self, "_decoded", None)
        if cache is not None:
            cache.pop(rid, None)
        self._version = getattr(self, "_version", 0) + 1
        nsites = np.flatnonzero(codes == 4)
        c = codes.copy()
        c[nsites] = 0
        self._packed_list[rid] = pack_2bit(c)
        newlen = len(codes)
        delta = newlen - int(self.lens[rid])
        if delta:
            self.lens[rid] = newlen
            self.offsets = np.concatenate(
                [[0], np.cumsum(self.lens)]).astype(np.int64)
        self._n_sites[rid] = nsites.astype(np.int64)

    def get_seq(self, rid: int) -> bytes:
        return codes_to_seq(self.get_codes(rid))

    def append_read(self, name: str, codes: np.ndarray,
                    trio_flag: int = 0) -> int:
        """Append a new (pseudo-)read — e.g. a UL gap-fill segment — and
        return its rid. Invalidates the flat-bank cache."""
        self._version = getattr(self, "_version", 0) + 1
        rid = self.n_reads
        nsites = np.flatnonzero(codes == 4)
        c = codes.copy()
        c[nsites] = 0
        self._packed_list.append(pack_2bit(c))
        self.names.append(name)
        self._n_sites.append(nsites.astype(np.int64))
        self.lens = np.append(self.lens, len(codes))
        self.offsets = np.append(self.offsets,
                                 self.offsets[-1] + len(codes))
        if self.trio_flags is not None:
            self.trio_flags = np.append(
                self.trio_flags, np.uint8(trio_flag))
        return rid


def _iter_all(path: str):
    from hifiasm_tpu_torch.io.fastx import iter_fastx

    yield from iter_fastx(path)


def _iter_all_q(path: str):
    from hifiasm_tpu_torch.io.fastx import iter_fastx_q

    yield from iter_fastx_q(path)
