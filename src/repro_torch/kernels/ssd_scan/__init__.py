from repro_torch.kernels.ssd_scan.ops import ssd, ssd_with_state
from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunked,
    ssd_naive_ref,
    ssd_scan_naive,
    ssd_scan_ref,
)

__all__ = ["ssd", "ssd_with_state", "ssd_chunked", "ssd_naive_ref", "ssd_scan_ref",
           "ssd_scan_naive"]
