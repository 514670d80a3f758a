from chamjax_torch.ops.coarse import (  # noqa: F401
    coarse_scan, coarse_scan_2stage, select_probes,
)
from chamjax_torch.ops.lut import build_luts  # noqa: F401
from chamjax_torch.ops.topk import select_topk, merge_topk  # noqa: F401
from chamjax_torch.ops.scan_xla import scan_lists_xla  # noqa: F401
