from hifiasm_tpu_torch.overlap.anchors import (  # noqa: F401
    Anchors, OverlapRegions, collect_anchors, chain_anchors,
    filter_overlaps_quota,
)
