"""Row gather and its scatter-add adjoint.

``row_scatter_add`` is kernel C′ of ``csrc/rowops.cu`` (it replaces
``materialist_tpu/ops/pallas/rowops.py::row_scatter_add``); its plain
version sums each row's contributions after a stable sort, in float64.
``row_gather`` is plain indexing, as the JAX package's non-coherent
gather is (``rowops.py:132-133``); the coherent gather kernel serves only
wavefront compaction, which this package does not have yet.
"""

from __future__ import annotations

import torch

from materialist_tpu_torch.ops.kernels import _lib


def row_gather(table, idx):
    """table (N, K); idx (...,) integer → (..., K) float32."""
    return table[idx.long()].to(torch.float32)


def row_scatter_add_plain(cot, idx, n_rows: int, exact: bool = True):
    """Σ of cot rows (..., K) at idx (...,) into (n_rows, K) float32:
    stable sort by row, float64 prefix sums, one sum per distinct row."""
    k = cot.shape[-1]
    c = cot.reshape(-1, k).to(torch.float32)
    if not exact:
        c = c.to(torch.bfloat16).to(torch.float32)
    i = idx.reshape(-1).long()
    out = torch.zeros((n_rows, k), dtype=torch.float32, device=cot.device)
    if i.numel() == 0:
        return out
    i_s, order = torch.sort(i, stable=True)
    cs = torch.cumsum(c[order].to(torch.float64), dim=0)
    last = torch.ones_like(i_s, dtype=torch.bool)
    last[:-1] = i_s[1:] != i_s[:-1]
    ends = cs[last]
    sums = torch.cat([ends[:1], ends[1:] - ends[:-1]])
    out[i_s[last]] = sums.to(torch.float32)
    return out


def row_scatter_add(cot, idx, n_rows: int, exact: bool = True):
    """Kernel C′: Σ over queries of cot rows at idx → (n_rows, K) f32.
    ``exact=False`` rounds each contribution to bf16 before the sum."""
    if cot.device.type == "cpu":
        return row_scatter_add_plain(cot, idx, n_rows, exact)
    dev = cot.device
    k = cot.shape[-1]
    cf = cot.reshape(-1, k).contiguous()
    ix = idx.reshape(-1).contiguous()
    m = cf.shape[0]
    _lib.expect(cf, "cot", torch.float32, (m, k), dev)
    _lib.expect(ix, "idx", torch.int32, (m,), dev)
    out = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    _lib.check(_lib.lib().row_scatter_add_launch(
        cf.data_ptr(), ix.data_ptr(), out.data_ptr(), m, k, n_rows,
        0 if exact else 1, _lib.stream_ptr(cf)), "row_scatter_add")
    _lib.LAUNCHES["row_scatter_add" if exact else "row_scatter_add_bf16"] += 1
    return out
