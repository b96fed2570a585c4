"""Multi-device check of the port (port of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py``).

``dryrun_multichip(mesh, synth)`` runs, on the given mesh: the sharded
window-alignment step (K1 on every shard), the sharded chain step, the
routed count and postings lookups over a bucket-sharded index, the
table built on the mesh against the host table, and a small full
assembly on the mesh, byte-identical to the run on its first device
alone.  ``synth`` supplies ``make_genome`` and ``sample_reads`` (the
repository's tests/synth.py); ``bases`` sizes the assembly.  Any
mismatch raises ``AssertionError``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from hifiasm_tpu_torch.index.pos_table import (
    PositionTable, build_position_table,
)
from hifiasm_tpu_torch.parallel.index_shard import (
    ShardedIndex, ShardedPostings, build_sharded_postings_mesh, hash_bits,
    make_sharded_cnt, make_sharded_postings, sharded_cnt_np,
)
from hifiasm_tpu_torch.parallel.mesh import Mesh
from hifiasm_tpu_torch.parallel.sharded_align import (
    make_sharded_align_step, make_sharded_chain_step,
)


def dryrun_multichip(mesh: Mesh, synth, bases: int = 3_000_000) -> dict:
    """Returns what it checked: window and chain batch sizes, lookups,
    the mesh table's distinct hashes and the assembly's GFA bytes."""
    from hifiasm_tpu_torch.assemble import assemble
    from hifiasm_tpu_torch.config import HifiasmConfig
    from hifiasm_tpu_torch.io.readstore import ReadStore

    n = len(mesh)
    rng = np.random.default_rng(11)
    out = {}

    # window-alignment step, batch split over the mesh
    e, XL = 15, 64
    YL = XL + 2 * e
    B = 8 * n
    y = rng.integers(0, 4, (B, YL)).astype(np.uint8)
    x = y[:, e:e + XL].copy()
    xlen = np.full(B, XL, np.int32)
    ylen = np.full(B, YL, np.int32)
    *_, stats = make_sharded_align_step(mesh, e)(x, xlen, y, ylen)
    assert int(stats[0]) == B, f"sharded align failed: {stats}"
    out["align_windows"] = B

    # anchor-chain DP step, batch split
    N, Bc = 32, 4 * n
    self_off = np.sort(rng.integers(0, 2000, (Bc, N)), axis=1).astype(
        np.int32)
    t_off = self_off + rng.integers(-3, 4, (Bc, N)).astype(np.int32)
    best, _ = make_sharded_chain_step(mesh)(
        self_off, t_off, np.full((Bc, N), 51, np.int32),
        np.ones((Bc, N), np.int32), np.full(Bc, N, np.int32),
        np.full(Bc, 2100, np.int32), np.full(Bc, 2100, np.int32))
    assert best.shape == (Bc,)
    out["chain_groups"] = Bc

    # bucket-sharded index with routed lookups (power-of-two meshes only,
    # as in the JAX package)
    if n & (n - 1):
        return out
    H = 64 * n
    hashes = np.sort(rng.integers(1, 1 << 62, H).astype(np.uint64))
    pt = PositionTable(
        hashes=hashes, start=np.arange(H, dtype=np.int64) * 2,
        count=np.full(H, 2, np.int32), rid=np.arange(2 * H, dtype=np.uint32),
        pos=np.arange(2 * H, dtype=np.uint32) * 7,
        rev=np.zeros(2 * H, np.uint8), span=np.full(2 * H, 51, np.uint16))
    per_dev = 16
    qs = hashes[:per_dev * n]
    got = sharded_cnt_np(make_sharded_cnt(mesh, ShardedIndex.build(pt, n),
                                          cap=4 * per_dev), qs)
    assert (got == 2).all(), "sharded index lookup failed"
    n_p, rid_p, _ = make_sharded_postings(
        mesh, ShardedPostings.build(pt, n), cap=4 * per_dev,
        k_post=4)(hash_bits(qs))
    assert (n_p.cpu() == 2).all(), "sharded postings gather failed"
    want0 = (int(pt.rid[pt.start[0]]) << 1) | int(pt.rev[pt.start[0]])
    i0 = int(np.flatnonzero(qs == hashes[0])[0])
    assert int(rid_p[i0, 0]) == want0, "postings content mismatch"
    out["lookups"] = len(qs)

    # the table built on the mesh answers like the host table
    gi = synth.make_genome(rng, 120_000)
    ri, _, _ = synth.sample_reads(rng, gi, depth=8, read_len=8000,
                                  err_rate=0.002)
    pt_h, _, _, mz_h = build_position_table(ri, 51, 51)
    qf, _, hlen_m = build_sharded_postings_mesh(mesh, mz_h)
    assert int(hlen_m.sum()) == pt_h.n_distinct, \
        "mesh-built table size mismatch"
    n_m, _, _ = qf(int(pt_h.count.max()))(hash_bits(pt_h.hashes[:64 * n]))
    assert (n_m.cpu().numpy() == pt_h.count[:64 * n]).all(), \
        "mesh-built table lookups diverge from the host table"
    out["mesh_table_distinct"] = int(hlen_m.sum())

    # a full assembly, 2 EC rounds, repeat-skewed genome: the mesh
    # against the mesh's first device alone, byte for byte
    g = synth.make_genome(rng, max(bases // 5, 9000), repeat_frac=0.08)
    reads, _, _ = synth.sample_reads(rng, g, depth=5, read_len=15000,
                                     err_rate=0.003)
    names = [f"r{i}" for i in range(len(reads))]
    gfa = {}
    with tempfile.TemporaryDirectory() as td:
        for tag, m in (("one", None), ("all", mesh)):
            cfg = HifiasmConfig(output_prefix=os.path.join(td, tag),
                                n_rounds_ec=2, ignore_bin=True,
                                mesh_devices=1 if m is None else 0)
            assemble(ReadStore.from_arrays(names, [r.copy() for r in reads]),
                     cfg, device=mesh.devices[0], mesh=m)
            with open(os.path.join(td, f"{tag}.bp.p_ctg.gfa"), "rb") as f:
                gfa[tag] = f.read()
    assert gfa["one"] == gfa["all"], "mesh assembly diverged from one device"
    assert len(gfa["one"]) > 0, "empty contig output"
    out["assembly_bases"] = int(sum(len(r) for r in reads))
    out["gfa_bytes"] = len(gfa["one"])
    if mesh.devices[0].type == "cuda":
        torch.cuda.synchronize()
    return out
