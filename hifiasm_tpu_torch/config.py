"""Assembler configuration.

Re-expresses the reference's global ``hifiasm_opt_t`` (CommandLines.h:35-175)
as an immutable-ish dataclass; defaults mirror ``init_opt``
(CommandLines.cpp:243-380). Coverage-derived updates (``ha_opt_update_cov``,
CommandLines.h:179) are methods here instead of global mutation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class HifiasmConfig:
    # --- inputs / outputs ---
    read_files: List[str] = field(default_factory=list)
    output_prefix: str = "hifiasm_tpu.asm"
    threads: int = 1                      # host-side worker threads

    # --- k-mer / minimizer (CommandLines.cpp:260-269) ---
    k: int = 51                           # k_mer_length (HPC k-mer)
    w: int = 51                           # mz_win
    hic_k: int = 31
    ul_k: int = 19
    ul_w: int = 19
    mz_rewin: int = 1000                  # adaptive re-selection window
    mz_sample_dist: int = 500             # high-occ sampling distance
    bf_shift: int = 37                    # bloom filter bits (0 = off, -f0)
    max_kmer_cnt: int = 2000              # index count cutoff clamp
    high_factor: float = 5.0              # filter-table threshold = hom_cov*high_factor
    min_hist_kmer_cnt: int = 5

    # --- error correction (CommandLines.cpp:272-281) ---
    max_ov_diff_ec: float = 0.04          # EC alignment error budget
    max_ov_diff_final: float = 0.03       # final-pass error budget
    n_rounds_ec: int = 3                  # number_of_round
    # True = legacy full realign of all overlaps after correction; the
    # default mirrors the reference (final records come from the last EC
    # round; cal_ov_r's realign worker is disabled, ecovlp.cpp:6391)
    final_realign: bool = False
    max_n_chain: int = 100                # MIN_N_CHAIN (CommandLines.h:29)
    is_ont: bool = False                  # --ont: ONT R10 mode
    adapter_len: int = 0                  # -z: clip read ends
    chemical_cov: int = 1                 # --chem-c (CommandLines.cpp:370)
    chemical_flank: int = 256             # --chem-f

    @property
    def ec_window(self) -> int:
        """WINDOW_OHC for ONT, WINDOW_HC for HiFi (ecovlp.cpp:3288)."""
        return 375 if self.is_ont else 775

    # --- coverage (auto-detected unless set) ---
    hom_cov: int = 20
    het_cov: int = -1024

    # --- graph cleaning (CommandLines.cpp:284-298) ---
    clean_rounds: int = 4
    min_drop_rate: float = 0.2
    max_drop_rate: float = 0.8
    small_pop_bubble_size: int = 0
    large_pop_bubble_size: int = 10_000_000
    max_hang_len: int = 1000
    max_hang_rate: float = 0.8
    gap_fuzz: int = 1000                  # transitive-reduction fuzz
    min_overlap_len: int = 50
    min_overlap_coverage: int = 0
    max_short_tip: int = 3

    # --- purge dups (CommandLines.cpp:299-310) ---
    purge_level: int = 3                  # -l: 0 off .. 3 aggressive
    purge_simi_rate_l2: float = 0.75
    purge_simi_rate_l3: float = 0.55
    purge_overlap_len: int = 1            # -O min linked reads
    max_contig_tip: int = 3               # --ctg-n
    post_join: int = 1                    # -u (CommandLines.cpp:126)
    purge_max_cov: int = -1               # --purge-max (-1 auto)
    trans_base_rate_sec: float = 0.5      # --s-base (-1 disables)

    # --- trio ---
    fn_bin_yak_pat: Optional[str] = None  # -1 pat.yak
    fn_bin_yak_mat: Optional[str] = None  # -2 mat.yak
    fn_bin_list_pat: Optional[str] = None  # -3 read-name list
    fn_bin_list_mat: Optional[str] = None  # -4 read-name list
    min_cnt: int = 2                      # yak min_cnt
    mid_cnt: int = 5                      # yak mid_cnt

    # --- hi-c ---
    hic_reads_1: List[str] = field(default_factory=list)
    hic_reads_2: List[str] = field(default_factory=list)

    # --- ultralong ---
    ul_reads: List[str] = field(default_factory=list)
    ul_error_rate: float = 0.2
    ul_ec_round: int = 3
    ul_min_base: int = 0                  # --ul-cut

    # --- phasing solver (CommandLines.cpp:325-328) ---
    seed: int = 11
    n_perturb: int = 10_000
    f_perturb: float = 0.1
    n_weight: int = 3
    polyploidy: int = 2                   # --n-hap
    misjoin_len: int = 500_000            # --l-msjoin; 0 disables
    b_low_cov: int = 0                    # --b-cov; 0 disables
    b_high_cov: int = -1                  # --h-cov; -1 disables
    m_rate: float = 0.75                  # --m-rate
    hg_size: int = -1                     # --hg-size (bases; -1 auto)
    trio_flag_occ_thres: int = 60         # --t-occ (CommandLines.cpp:321)
    trio_dual: bool = False               # --trio-dual
    telo_min_score: int = 10              # --telo-s
    telo_pen: Optional[int] = None        # --telo-p (scored end scan)
    telo_drop: Optional[int] = None       # --telo-d (scored end scan)

    # --- scaffolding / BED output ---
    scaf_gap_max: int = 3_000_000         # --scaf-gap (CommandLines.cpp:358)
    bed_inconsist_rate: int = 70          # --lowQ; 0 disables the BED

    # --- misc / output flags ---
    write_paf: bool = False
    write_ec: bool = False
    primary: bool = False                 # --primary: p_ctg + a_ctg
    telo_motif: Optional[str] = None
    ignore_bin: bool = False              # -i: ignore saved checkpoints
    ex_list: Optional[str] = None         # -e: read-name trace list
    dual_scaf: bool = False               # --dual-scaf self-scaffolding
    dbg_gfa: bool = False                 # --dbg-gfa graph checkpoint
    dbg_ovec: bool = False                # --dbg-ovec: EC overlap dump, stop
    fast: bool = False                    # --fast (N/A: single-pass build)
    ul_tip: int = 6                       # --ul-tip (CommandLines.cpp:295)
    path_min: float = 0.2                 # --path-min (UL arc-drop ladder)
    path_max: float = 0.6                 # --path-max
    rl_cut: int = 1000                    # --rl-cut (ONT length filter)
    sc_cut: int = 10                      # --sc-cut (ONT mean-qual filter)
    recover_atg_cov_min: int = -1         # --pri-range lo (-1 disables)
    recover_atg_cov_max: int = 1 << 30    # --pri-range hi
    sec_in: Optional[list] = None         # --sec-in: corrected read files
    hic_enzymes: Optional[list] = None    # --enzyme (informational: the
    #   PE mapper is k-mer exact+rescue, enzyme-agnostic by design)
    low_het: bool = False                 # --low-het (reserved, like the
    #   reference's commented-out usage, gfa_ut.cpp:15341)

    # --- hidden longopts (CommandLines.cpp:18-88, not in --help) ---
    skip_triobin: bool = False     # --skip-triobin: parse -1/-2 but skip
    #   binning (the reference parses HA_F_SKIP_TRIOBIN,
    #   CommandLines.cpp:918 / CommandLines.h:17)
    bin_only: bool = False         # --bin-only: stop after writing the
    #   checkpoint bins (Overlaps.cpp:23585, inter.cpp:21639)
    somatic_cov: int = -1          # --somatic-cov: fixed diploid-coverage
    #   ceiling for somatic bubble flattening (Overlaps.cpp:39127)
    kpt_rate: float = -1.0         # --kpt-rate: trio mode extra .kdp graph
    #   of unitigs mostly unused by either haplotype
    #   (filter_set_kug, Overlaps.cpp:21286,21353)
    unskew: bool = False           # --unskew: disable skew normalization of
    #   Hi-C trans weights (hic.cpp:16029 weight_kv_u_trans norm arg)
    integer_correct_round: int = 0 # --integer-correct: extra UL integer-
    #   space re-correction rounds (gfa_ut.cpp:17648 ul_re_correct)
    extract_iter: int = 0          # --ex-iter: BFS rounds expanding the
    #   -e read set over the overlap graph before the PAF-style dump
    #   (extract.cpp:78 ha_extract_print)
    dp_e: float = 0.0025           # --dp-er: sketch-refine error rate
    #   (CommandLines.cpp:330; sketch.cpp:576 refine_sketch)
    dp_min_len: int = 2000         # dense-region min length for refine
    prt_raw: bool = False          # --prt-raw: dump the raw string graph
    #   as <prefix>.raw.gfa before cleaning (Overlaps.cpp:39200,39248)
    dbg_het_cnt: bool = False      # --dbg-het-cnt: per-read het-evidence
    #   counts to <prefix>.het_cnt.log on the last EC round
    #   (Assembly.cpp:1014,968)

    # --- device execution ---
    profile_dir: Optional[str] = None     # --profile: torch.profiler traces
    read_batch: int = 64                  # reads per device batch
    max_read_len: int = 65536             # padded read length cap
    use_pallas: bool = True               # use Pallas kernels when on TPU
    align_engine: str = "auto"            # auto | jax | native | numpy
    # multi-chip: 0 = use every visible device when the device path is
    # active (>1 device -> mesh-sharded EC + bucket-sharded index);
    # 1 pins single-device; N caps the mesh size
    mesh_devices: int = 0
    # below this input size the device path cannot amortize its launch
    # costs; route EC to the native host engine instead (auto mode only)
    device_min_bases: int = 50_000_000
    # HBM-resident front end on the device path (single device): sketch,
    # position table, and anchor gather on the accelerator
    # (ops/sketch_jax.py + index/pos_table_jax.py)
    device_frontend: bool = True

    def update_cov(self, hom_cov: int, het_cov: int = -1024) -> None:
        """Coverage-derived config update (~ha_opt_update_cov)."""
        self.hom_cov = hom_cov
        if het_cov > 0:
            self.het_cov = het_cov

    def replace(self, **kw) -> "HifiasmConfig":
        return dataclasses.replace(self, **kw)


# EC window constants (Hash_Table.h:9-34)
WINDOW = 375
WINDOW_HC = 775
THRESHOLD = 15            # max errors per window (band radius)
THRESHOLD_MAX_SIZE = 31   # absolute error cap -> band fits 2*31+1=63 bits
WINDOW_UL = 75
WINDOW_UL_H = 200
GROUP_SIZE = 4
OVERLAP_THRESHOLD_HIFI_FILTER = 0.9
