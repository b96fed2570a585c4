"""FASTA/FASTQ (.gz) streaming reader.

Host-side input stage — the analog of the reference's kseq.h-based readers
(Process_Read.cpp). Yields (name, seq_bytes) tuples; sequences are raw ASCII
bytes (upper/lower accepted).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple


def _open_maybe_gz(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20)


def iter_fastx(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence) from a FASTA or FASTQ file, optionally gzipped."""
    with _open_maybe_gz(path) as f:
        first = f.peek(1)[:1]
        if first == b">":
            yield from _iter_fasta(f)
        elif first == b"@":
            yield from _iter_fastq(f)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_fasta(f) -> Iterator[Tuple[str, bytes]]:
    name = None
    chunks = []
    for line in f:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield name, b"".join(chunks)
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


def _iter_fastq(f) -> Iterator[Tuple[str, bytes]]:
    while True:
        hdr = f.readline()
        if not hdr:
            return
        seq = f.readline().rstrip(b"\r\n")
        f.readline()  # '+'
        f.readline()  # qual
        name = hdr[1:].rstrip(b"\r\n").split()[0].decode()
        yield name, seq


def iter_fastx_q(path: str) -> Iterator[Tuple[str, bytes, bytes]]:
    """Like iter_fastx but also yields the quality string (b"" for
    FASTA records) — used by the --sc-cut mean-quality filter."""
    with _open_maybe_gz(path) as f:
        first = f.peek(1)[:1]
        if first == b">":
            for name, seq in _iter_fasta(f):
                yield name, seq, b""
        elif first == b"@":
            while True:
                hdr = f.readline()
                if not hdr:
                    return
                seq = f.readline().rstrip(b"\r\n")
                f.readline()  # '+'
                qual = f.readline().rstrip(b"\r\n")
                name = hdr[1:].rstrip(b"\r\n").split()[0].decode()
                yield name, seq, qual
        elif first == b"":
            return
        else:
            raise ValueError(
                f"{path}: not FASTA/FASTQ (starts with {first!r})")
