from hifiasm_tpu_torch.index.count import analyze_count, histogram_counts  # noqa: F401
from hifiasm_tpu_torch.index.pos_table import FilterTable, PositionTable  # noqa: F401
