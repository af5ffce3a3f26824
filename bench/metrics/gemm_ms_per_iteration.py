"""gemm_ms_per_iteration: device milliseconds of the matrix-product
library kernels (cuBLAS / CUTLASS names) in the traced stretch over its
scheduler iterations."""
from bench.lib import trace as T


def read(rec):
    tr = rec.trace
    if tr is None or not tr.iterations or not tr.kernels:
        return None
    return 1e3 * T.gemm_seconds(tr.kernels) / tr.iterations
