from . import ops, ref
from .ops import dfr_scan, dfr_scan_grad, dfr_scan_grad_plain, dfr_scan_plain
from .ref import dfr_scan_ref

__all__ = ["dfr_scan", "dfr_scan_grad", "dfr_scan_grad_plain", "dfr_scan_plain",
           "dfr_scan_ref", "ops", "ref"]
