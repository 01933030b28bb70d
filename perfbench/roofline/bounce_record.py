"""Kernel H (``bounce_record``), a fused bounce's trace record, one launch
at (rows m, envmap h, w, the alive flags' own elements, the normals' own
rows): read once, wi and wi_e (12 B each), pdf_e (4 B), hit and shadowed
(1 B each) a row, the alive flags (1 B) and normals (12 B) at their own
sizes (bounce 0 broadcasts both over the samples), the pdf tables once;
written once, aux 5 × 2, recb 13 × 2 and the f16 normal 3 × 2 B a row;
120 operations a row, from ``chip_smoke.py:149,160-169``."""

KERNELS = ("bounce_record_kernel",)

READ_BYTES_A_ROW = 12 + 12 + 4 + 1 + 1
WRITE_BYTES_A_ROW = (5 + 13 + 3) * 2


def bound(shape):
    m, h, w, n_alive, n_nrm = shape
    return (m * (READ_BYTES_A_ROW + WRITE_BYTES_A_ROW) + n_alive + 12 * n_nrm
            + 4 * (h + h * w), m * 120)
