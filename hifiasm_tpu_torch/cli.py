"""Command-line interface (~CommandLines.cpp:18-86 ketopt table).

The option surface of hifiasm_tpu/cli.py plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path).  The UL options, whose
branch the port has not reached yet, parse as before and raise
``NotImplementedError`` when the assembly starts.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from hifiasm_tpu_torch.config import HifiasmConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hifiasm_tpu_torch",
        description="PyTorch/CUDA haplotype-resolved de novo assembler "
                    "(hifiasm-compatible capabilities)")
    p.add_argument("reads", nargs="*", help="input HiFi reads (fa/fq[.gz])")
    p.add_argument("-o", dest="output_prefix", default="hifiasm_tpu.asm",
                   help="prefix of output files [%(default)s]")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="number of host worker threads [%(default)s]")
    p.add_argument("-k", dest="k", type=int, default=51,
                   help="k-mer length (must be odd) [%(default)s]")
    p.add_argument("-w", dest="w", type=int, default=51,
                   help="minimizer window size [%(default)s]")
    p.add_argument("-f", dest="bf_shift", type=int, default=37,
                   help="bloom filter bits; 0 to disable [%(default)s]")
    p.add_argument("-r", dest="n_rounds_ec", type=int, default=3,
                   help="rounds of haplotype-aware error correction "
                        "[%(default)s]")
    p.add_argument("-a", dest="clean_rounds", type=int, default=4,
                   help="rounds of assembly graph cleaning [%(default)s]")
    p.add_argument("-l", dest="purge_level", type=int, default=3,
                   choices=(0, 1, 2, 3),
                   help="purge level: 0 none, 1 contained, 2/3 aggressive "
                        "[%(default)s]")
    p.add_argument("-s", dest="purge_simi_rate", type=float, default=0.55,
                   help="similarity threshold for duplicate haplotigs "
                        "[%(default)s]")
    p.add_argument("-D", dest="high_factor", type=float, default=5.0,
                   help="drop k-mers occurring > FLOAT*coverage times "
                        "[%(default)s]")
    p.add_argument("-N", dest="max_n_chain", type=int, default=100,
                   help="consider up to max(-D*coverage,-N) overlaps "
                        "[%(default)s]")
    p.add_argument("-z", dest="adapter_len", type=int, default=0,
                   help="length of adapters to be removed [%(default)s]")
    p.add_argument("-m", dest="large_pop_bubble_size", type=int,
                   default=10_000_000,
                   help="pop bubbles of <INT in size in contig graphs "
                        "[%(default)s]")
    p.add_argument("-p", dest="small_pop_bubble_size", type=int, default=0,
                   help="pop bubbles of <INT in size in unitig graphs "
                        "[%(default)s]")
    p.add_argument("-n", dest="max_short_tip", type=int, default=3,
                   help="remove tip unitigs composed of <=INT reads "
                        "[%(default)s]")
    p.add_argument("-x", dest="max_drop_rate", type=float, default=0.8,
                   help="max overlap drop ratio [%(default)s]")
    p.add_argument("-y", dest="min_drop_rate", type=float, default=0.2,
                   help="min overlap drop ratio [%(default)s]")
    p.add_argument("-u", dest="post_join", type=int, default=1,
                   choices=(0, 1),
                   help="post-join step for contigs which may improve "
                        "N50; 0 to disable [%(default)s]")
    p.add_argument("--max-kocc", dest="max_kmer_cnt", type=int,
                   default=2000,
                   help="employ k-mers occurring <INT times to rescue "
                        "repetitive overlaps [%(default)s]")
    p.add_argument("--n-weight", dest="n_weight", type=int, default=3,
                   help="rounds of reweighting Hi-C links [%(default)s]")
    p.add_argument("--l-msjoin", dest="misjoin_len", type=int,
                   default=500_000,
                   help="detect misjoined unitigs of >=INT in size; "
                        "0 to disable [%(default)s]")
    p.add_argument("--b-cov", dest="b_low_cov", type=int, default=0,
                   help="break contigs at positions with <INT-fold "
                        "coverage; 0 to disable [%(default)s]")
    p.add_argument("--h-cov", dest="b_high_cov", type=int, default=-1,
                   help="break contigs at positions with >INT-fold "
                        "coverage; -1 to disable [%(default)s]")
    p.add_argument("--m-rate", dest="m_rate", type=float, default=0.75,
                   help="break threshold rate with --b-cov/--h-cov "
                        "[%(default)s]")
    p.add_argument("--n-hap", dest="polyploidy", type=int, default=2,
                   help="number of haplotypes [%(default)s]")
    p.add_argument("--scaf-gap", dest="scaf_gap_max", type=int,
                   default=3_000_000,
                   help="max gap size for scaffolding [%(default)s]")
    p.add_argument("--lowQ", dest="bed_inconsist_rate", type=int,
                   default=70,
                   help="output contig regions with >=INT%% inconsistency "
                        "in BED format; 0 to disable [%(default)s]")
    p.add_argument("--hg-size", dest="hg_size", default=None,
                   metavar="INT(k/m/g)",
                   help="estimated haploid genome size for inferring read "
                        "coverage [auto]")
    p.add_argument("--t-occ", dest="trio_flag_occ_thres", type=int,
                   default=60,
                   help="forcedly remove unitigs with >INT unexpected "
                        "haplotype-specific reads [%(default)s]")
    p.add_argument("--telo-s", dest="telo_min_score", type=int, default=10,
                   help="min motif hits for telomere reads [%(default)s]")
    p.add_argument("--trio-dual", dest="trio_dual", action="store_true",
                   help="utilize homology information to correct trio "
                        "phasing errors")
    p.add_argument("--chem-c", dest="chemical_cov", type=int, default=1,
                   help="detect chimeric reads with <=INT other reads "
                        "support (--ont mode) [%(default)s]")
    p.add_argument("--chem-f", dest="chemical_flank", type=int,
                   default=256,
                   help="length of flanking regions for chimeric read "
                        "detection [%(default)s]")
    p.add_argument("--purge-max", dest="purge_max_cov", type=int,
                   default=-1,
                   help="coverage upper bound of purge-dups; -1 auto "
                        "[%(default)s]")
    p.add_argument("--s-base", dest="trans_base_rate_sec", type=float,
                   default=0.5,
                   help="base-level similarity threshold for homology "
                        "detection; -1 to disable [%(default)s]")
    p.add_argument("-O", dest="purge_overlap_len", type=int, default=1,
                   help="min number of overlapped reads for duplicate "
                        "haplotigs [%(default)s]")
    p.add_argument("--ctg-n", dest="max_contig_tip", type=int, default=3,
                   help="remove tip contigs composed of <=INT reads "
                        "[%(default)s]")
    p.add_argument("--ul-cut", dest="ul_min_base", type=int, default=0,
                   help="filter out <INT-base UL reads [%(default)s]")
    p.add_argument("--min-hist-cnt", dest="min_hist_kmer_cnt", type=int,
                   default=5, help="low k-mer histogram cut [%(default)s]")
    p.add_argument("--primary", action="store_true",
                   help="output a primary and an alternate assembly")
    p.add_argument("--n-perturb", dest="n_perturb", type=int, default=10000)
    p.add_argument("--f-perturb", dest="f_perturb", type=float, default=0.1)
    p.add_argument("--seed", dest="seed", type=int, default=11)
    p.add_argument("--write-paf", action="store_true",
                   help="dump overlaps in PAF")
    p.add_argument("--write-ec", action="store_true",
                   help="dump error-corrected reads in FASTA")
    # trio
    p.add_argument("-1", dest="fn_bin_yak_pat", metavar="FILE",
                   help="hap1/paternal k-mer dump (yak)")
    p.add_argument("-2", dest="fn_bin_yak_mat", metavar="FILE",
                   help="hap2/maternal k-mer dump (yak)")
    p.add_argument("-3", dest="fn_bin_list_pat", metavar="FILE",
                   help="list of hap1/paternal read names")
    p.add_argument("-4", dest="fn_bin_list_mat", metavar="FILE",
                   help="list of hap2/maternal read names")
    p.add_argument("-c", dest="min_cnt", type=int, default=2,
                   help="lower bound of the binned k-mer's frequency")
    p.add_argument("-d", dest="mid_cnt", type=int, default=5,
                   help="upper bound of the binned k-mer's frequency")
    # hi-c
    p.add_argument("--h1", dest="hic_reads_1", action="append", default=[],
                   metavar="FILE", help="Hi-C R1 reads")
    p.add_argument("--h2", dest="hic_reads_2", action="append", default=[],
                   metavar="FILE", help="Hi-C R2 reads")
    # ultralong
    p.add_argument("--ul", dest="ul_reads", action="append", default=[],
                   metavar="FILE", help="ultralong ONT reads")
    p.add_argument("--ul-rate", dest="ul_error_rate", type=float,
                   default=0.2)
    p.add_argument("--ul-round", dest="ul_ec_round", type=int, default=3)
    p.add_argument("--ul-tip", dest="ul_tip", type=int, default=6,
                   help="remove UL-graph tip unitigs of <=INT reads")
    p.add_argument("--path-max", dest="path_max", type=float, default=0.6,
                   help="max UL path drop ratio")
    p.add_argument("--path-min", dest="path_min", type=float, default=0.2,
                   help="min UL path drop ratio")
    # misc
    p.add_argument("--telo-m", dest="telo_motif", metavar="MOTIF",
                   help="telomere motif, e.g. CCCTAA")
    p.add_argument("-e", "--ex-list", dest="ex_list", metavar="FILE",
                   help="trace the named reads' anchors/overlaps")
    p.add_argument("--dual-scaf", dest="dual_scaf", action="store_true",
                   help="scaffold each haplotype with the other's homology")
    p.add_argument("--dbg-gfa", dest="dbg_gfa", action="store_true",
                   help="checkpoint the string graph for standalone reruns")
    p.add_argument("--dbg-ovec", dest="dbg_ovec", action="store_true",
                   help="dump the EC overlap set (prefix.ovlp.paf) and stop")
    p.add_argument("--fast", dest="fast", action="store_true",
                   help="fast index counting (already the default here: "
                        "the sort/segment-reduce build is single-pass)")
    p.add_argument("--hom-cov", dest="hom_cov_set", type=int,
                   help="homozygous read coverage")
    p.add_argument("--max-od-ec", dest="max_ov_diff_ec", type=float,
                   default=0.04)
    p.add_argument("--max-od-final", dest="max_ov_diff_final", type=float,
                   default=0.03)
    p.add_argument("-i", dest="ignore_bin", action="store_true",
                   help="ignore saved overlaps/corrected reads")
    p.add_argument("--ont", dest="is_ont", action="store_true",
                   help="ONT R10 reads (smaller EC windows, higher e-rate)")
    p.add_argument("--telo-p", dest="telo_pen", type=int, default=None,
                   help="non-telomeric penalty (scored end scan)")
    p.add_argument("--telo-d", dest="telo_drop", type=int, default=None,
                   help="max telomere score drop")
    p.add_argument("--rl-cut", dest="rl_cut", type=int, default=1000,
                   help="filter ONT reads shorter than INT (--ont)")
    p.add_argument("--sc-cut", dest="sc_cut", type=int, default=10,
                   help="filter ONT fastq reads with mean qual < INT")
    p.add_argument("--pri-range", dest="pri_range", metavar="INT1[,INT2]",
                   help="recover alternate unitigs with coverage in the "
                        "range back into primary")
    p.add_argument("--enzyme", dest="hic_enzymes", action="append",
                   default=None, metavar="STR",
                   help="Hi-C restriction enzymes (informational: the "
                        "PE mapper is k-mer based, enzyme-agnostic)")
    p.add_argument("--sec-in", dest="sec_in", action="append",
                   default=None, metavar="FILE",
                   help="extra pre-corrected read files assembled "
                        "jointly with the main input (one EC round)")
    p.add_argument("--low-het", dest="low_het", action="store_true",
                   help="genomes with very low heterozygosity (reserved)")
    # hidden longopts (absent from the reference --help too;
    # CommandLines.cpp:18-88)
    p.add_argument("--skip-triobin", dest="skip_triobin",
                   action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--bin-only", dest="bin_only", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--somatic-cov", dest="somatic_cov", type=int,
                   default=-1, help=argparse.SUPPRESS)
    p.add_argument("--kpt-rate", dest="kpt_rate", type=float, default=-1.0,
                   help=argparse.SUPPRESS)
    p.add_argument("--unskew", dest="unskew", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--integer-correct", dest="integer_correct_round",
                   type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--ex-iter", dest="extract_iter", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--dp-er", dest="dp_e", type=float, default=0.0025,
                   help=argparse.SUPPRESS)
    p.add_argument("--prt-raw", dest="prt_raw", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--dbg-het-cnt", dest="dbg_het_cnt",
                   action="store_true", help=argparse.SUPPRESS)
    # kept so command lines of hifiasm_tpu parse the same; inert here
    # (EC always runs on --device)
    p.add_argument("--align-engine", dest="align_engine", default="auto",
                   choices=("auto", "jax", "numpy"), help=argparse.SUPPRESS)
    p.add_argument("--profile", dest="profile_dir", metavar="DIR",
                   help=argparse.SUPPRESS)
    p.add_argument("--device", dest="device", default="cuda",
                   help="device for error correction: cuda or cpu "
                        "[%(default)s]")
    p.add_argument("--version", action="version", version="0.1.0")
    return p


def parse_config(argv: Optional[List[str]] = None) -> HifiasmConfig:
    return _parse(argv)[0]


def _parse(argv: Optional[List[str]] = None):
    ns = build_parser().parse_args(argv)
    cfg = HifiasmConfig()
    for f in ("output_prefix", "threads", "k", "w", "bf_shift",
              "n_rounds_ec", "clean_rounds", "purge_level", "high_factor",
              "max_n_chain", "min_hist_kmer_cnt", "n_perturb", "f_perturb",
              "seed", "min_cnt", "mid_cnt", "hic_reads_1", "hic_reads_2",
              "ul_reads", "ul_error_rate", "ul_ec_round", "telo_motif",
              "max_ov_diff_ec", "max_ov_diff_final", "align_engine",
              "fn_bin_yak_pat", "fn_bin_yak_mat", "ex_list", "dual_scaf",
              "is_ont", "adapter_len", "dbg_gfa", "dbg_ovec", "fast",
              "large_pop_bubble_size", "small_pop_bubble_size",
              "max_short_tip", "max_drop_rate", "min_drop_rate",
              "max_kmer_cnt", "n_weight", "polyploidy", "scaf_gap_max",
              "bed_inconsist_rate", "trio_flag_occ_thres",
              "telo_min_score", "purge_overlap_len", "max_contig_tip",
              "ul_min_base", "misjoin_len", "trio_dual", "b_low_cov",
              "b_high_cov", "m_rate", "chemical_cov", "chemical_flank",
              "purge_max_cov", "trans_base_rate_sec", "post_join",
              "ul_tip", "path_max", "path_min", "telo_pen", "telo_drop",
              "rl_cut", "sc_cut", "sec_in", "hic_enzymes", "low_het",
              "profile_dir", "skip_triobin", "bin_only", "somatic_cov",
              "kpt_rate", "unskew", "integer_correct_round",
              "extract_iter", "dp_e", "prt_raw", "dbg_het_cnt"):
        setattr(cfg, f, getattr(ns, f))
    if ns.pri_range:
        parts = ns.pri_range.split(",")
        cfg.recover_atg_cov_min = int(parts[0])
        if len(parts) > 1:
            cfg.recover_atg_cov_max = int(parts[1])
    cfg.read_files = ns.reads
    cfg.primary = ns.primary
    cfg.write_paf = ns.write_paf
    cfg.write_ec = ns.write_ec
    cfg.purge_simi_rate_l3 = ns.purge_simi_rate
    if ns.hom_cov_set:
        cfg.hom_cov = ns.hom_cov_set
    cfg.fn_bin_list_pat = getattr(ns, "fn_bin_list_pat", None)
    cfg.fn_bin_list_mat = getattr(ns, "fn_bin_list_mat", None)
    cfg.ignore_bin = ns.ignore_bin
    if ns.hg_size:
        mult = {"k": 1_000, "m": 1_000_000, "g": 1_000_000_000}
        v = ns.hg_size.strip().lower()
        cfg.hg_size = int(float(v[:-1]) * mult[v[-1]]) if v[-1] in mult \
            else int(float(v))
    return cfg, ns.device


def main(argv: Optional[List[str]] = None) -> int:
    cfg, device = _parse(argv)
    if not cfg.read_files:
        build_parser().print_help()
        return 1
    from hifiasm_tpu_torch.assemble import _check_ported, assemble
    from hifiasm_tpu_torch.device import resolve_device
    from hifiasm_tpu_torch.io.readstore import ReadStore
    from hifiasm_tpu_torch.native import set_threads
    from hifiasm_tpu_torch.utils.logging import log

    device = resolve_device(device)
    _check_ported(cfg)
    set_threads(cfg.threads)              # -t bounds the native kernels

    store = ReadStore.from_files(
        cfg.read_files, adapter_len=cfg.adapter_len,
        min_len=cfg.rl_cut if cfg.is_ont else 0,
        min_mean_q=cfg.sc_cut if cfg.is_ont else 0)
    if cfg.sec_in:
        # --sec-in: extra pre-corrected read sets assembled jointly with
        # one overlap round (~ha_assemble_pair, Assembly.cpp:2128)
        sec = ReadStore.from_files(cfg.sec_in)
        for rid in range(sec.n_reads):
            store.append_read(sec.names[rid], sec.get_codes(rid).copy())
        cfg.n_rounds_ec = 1
        log("main", f"--sec-in: appended {sec.n_reads} corrected reads; "
            f"single overlap round")
    log("main", f"loaded {store.n_reads} reads, {store.total_bases} bases")
    assemble(store, cfg, device=device)
    # closing summary (~main.cpp:69-73)
    import resource
    import time

    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cpu = time.process_time()
    print(f"[M::main] Version: 0.1.0 (hifiasm-tpu-torch)", file=sys.stderr)
    print(f"[M::main] CMD: hifiasm_tpu_torch "
          f"{' '.join(argv if argv is not None else sys.argv[1:])}",
          file=sys.stderr)
    print(f"[M::main] Real time: {time.time() - _T0:.3f} sec; "
          f"CPU: {cpu:.3f} sec; Peak RSS: {peak_gb:.3f} GB",
          file=sys.stderr)
    return 0


_T0 = __import__("time").time()


if __name__ == "__main__":
    sys.exit(main())
