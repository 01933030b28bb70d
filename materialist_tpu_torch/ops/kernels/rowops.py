"""Row gather, its scatter-add adjoint, and the wavefront-compaction
reorders built from the two (counterpart of
``materialist_tpu/ops/pallas/rowops.py``).

``row_gather`` is kernel C and ``row_scatter_add`` kernel C′ of
``csrc/rowops.cu``. Their plain versions are indexing and, for the
scatter, a stable sort with float64 prefix sums. On the card every call
of either goes through its kernel, whatever the order of the indices: the
JAX package's ``coherent`` flag chose between its span-binned kernel and
XLA's gather, a choice this card does not need, so ``row_gather`` accepts
the flag and it only documents that the caller's indices ascend.

The compaction helpers (``compact_sel``, ``gather_rows_coherent``,
``gather_coherent_diff``, ``scatter_add_coherent_diff``) keep the live
rays of a bounce as an ascending index vector, so the state of the next
bounce is one gather and the radiance returns to its film slots by one
scatter-add.
"""

from __future__ import annotations

import torch

from materialist_tpu_torch.ops.kernels import _lib


def row_gather_plain(table, idx, exact: bool = True):
    out = table[idx.long()].to(torch.float32)
    return out if exact else out.to(torch.bfloat16).to(torch.float32)


def row_gather(table, idx, exact: bool = True, coherent: bool = False):
    """Kernel C: table (N, K) f32; idx (...,) integer in [0, N) →
    (..., K) f32. ``exact=False`` rounds the fetched values to bf16."""
    if table.device.type == "cpu":
        return row_gather_plain(table.detach(), idx, exact)
    dev = table.device
    n, k = table.shape
    tf = table.detach().contiguous()
    ix = idx.reshape(-1).to(torch.int32).contiguous()
    m = ix.shape[0]
    _lib.expect(tf, "table", torch.float32, (n, k), dev)
    _lib.expect(ix, "idx", torch.int32, (m,), dev)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m:
        _lib.check(_lib.lib().row_gather_launch(
            tf.data_ptr(), ix.data_ptr(), out.data_ptr(), m, k,
            0 if exact else 1, _lib.stream_ptr(tf)), "row_gather")
        _lib.LAUNCHES["row_gather"] += 1
    return out.reshape(*idx.shape, k)


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


class _RowGatherDiff(torch.autograd.Function):
    """Forward kernel C, backward kernel C′ with bf16-rounded
    contributions (the JAX package's default adjoint). The index carries
    no gradient: estimator decisions are detached."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return row_gather(table, idx)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return row_scatter_add(cot.contiguous(), idx.to(torch.int32),
                               ctx.n_rows, exact=False), None


def row_gather_diff(table, idx):
    """Differentiable row gather for rows that no trace pass fetched."""
    return _RowGatherDiff.apply(table, idx)


# ------------------------------------------------------------ compaction

def _f32_exact_split(i):
    """int32 (< 2^26) → two f32-exact channels (hi, lo), base 2^13."""
    hi = torch.div(i, 8192, rounding_mode="floor")
    lo = i - hi * 8192
    return hi.to(torch.float32), lo.to(torch.float32)


def _f32_exact_join(hi, lo):
    return hi.to(torch.int32) * 8192 + lo.to(torch.int32)


def compact_sel_plain(alive, cap: int):
    """Plain version of ``compact_sel``: the positions of the first
    ``cap`` live rays, zero beyond their count."""
    pos = torch.nonzero(alive.reshape(-1))[:cap, 0].to(torch.int32)
    sel = torch.zeros((cap,), dtype=torch.int32, device=alive.device)
    sel[:pos.shape[0]] = pos
    return sel, torch.tensor(pos.shape[0], dtype=torch.int32,
                             device=alive.device)


def compact_sel(alive, cap: int):
    """Stable-compaction index vector of the live rays.

    alive (M,) bool → (sel (cap,) int32 ascending, count int32 scalar
    tensor). sel[j] is the position of the j-th live ray for j < count and
    0 (padding) beyond; live rays past ``cap`` are dropped and the
    estimator treats them as dead. The destination of a live ray is its
    prefix count, so the compaction is one scatter-add (kernel C′) of the
    positions, split into two f32-exact channels; dead rays add exact
    zeros, which the kernel skips, and every slot receives at most one
    value, so the result does not depend on the order of the atomic adds.
    ``count`` stays on the device: reading it would stall every chunk."""
    m = alive.shape[0]
    dest = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32) - 1
    count = torch.clamp_max(dest[-1] + 1, cap)
    keep = alive & (dest < cap)
    hi, lo = _f32_exact_split(torch.arange(m, dtype=torch.int32,
                                           device=alive.device))
    vals = torch.stack([torch.where(keep, hi, 0.0),
                        torch.where(keep, lo, 0.0)], dim=-1)
    packed = row_scatter_add(vals, torch.clamp(dest, 0, cap - 1), cap,
                             exact=True)
    return _f32_exact_join(packed[:, 0], packed[:, 1]), count


def gather_rows_coherent(table, sel):
    """Detached gather of table (M, K) rows at ascending sel (cap,):
    pulls the surviving rays' state through a compaction in one fetch
    (integers ride as f32 values, exact below 2^24)."""
    return row_gather(table.detach(), sel, exact=True, coherent=True)


class _GatherCoherentDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, sel):
        ctx.save_for_backward(sel)
        ctx.n_rows = table.shape[0]
        return row_gather(table, sel, exact=True, coherent=True)

    @staticmethod
    def backward(ctx, cot):
        (sel,) = ctx.saved_tensors
        return row_scatter_add(cot.contiguous(), sel, ctx.n_rows,
                               exact=True), None


def gather_coherent_diff(table, sel):
    """Differentiable gather at ascending ``sel`` (the throughput chain
    across a compaction): forward kernel C, backward kernel C′, exact."""
    return _GatherCoherentDiff.apply(table, sel)


class _ScatterAddCoherentDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, n_rows):
        ctx.save_for_backward(idx)
        return row_scatter_add(values.contiguous(), idx, n_rows, exact=True)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return row_gather(cot, idx, exact=True, coherent=True), None, None


def scatter_add_coherent_diff(n_rows: int, values, idx):
    """Differentiable scatter-add of ``values`` rows into an (n_rows, K)
    zero table at ascending idx (the film accumulation across a
    compaction): forward kernel C′, backward kernel C. Padding rows must
    carry zero values."""
    return _ScatterAddCoherentDiff.apply(values, idx, n_rows)
