"""Row gather, its scatter-add adjoint, and the wavefront-compaction
reorders built from the two (counterpart of
``materialist_tpu/ops/pallas/rowops.py``).

``row_gather`` is kernel C and ``row_scatter_add`` kernel C′ of
``csrc/rowops.cu``. Their plain versions are indexing and, for the
scatter, a stable sort with float64 prefix sums. On the card every call
of either goes through its kernel, whatever the order of the indices.
``coherent`` has the JAX package's meaning, the indices of the live rows
ascend (padding rows carry zeros): ``row_gather`` only records it with
the launch's shape, ``row_scatter_add`` takes its path without a match
and, for rows no other lane shares, without atomics.

The compaction helpers (``compact_sel``, ``gather_rows_coherent``,
``gather_coherent_diff``, ``scatter_add_coherent_diff``,
``scatter_add_coherent_into``) keep the live rays of a bounce as an
ascending index vector, so the state of the next bounce is one gather and
the radiance returns to its film slots by one scatter-add.
``compact_sel`` has a kernel of its own in ``csrc/rowops.cu``.
"""

from __future__ import annotations

import torch

from materialist_tpu_torch.ops.kernels import _lib


def row_gather_plain(table, idx, exact: bool = True):
    out = table[idx.long()].to(torch.float32)
    return out if exact else out.to(torch.bfloat16).to(torch.float32)


def row_gather(table, idx, exact: bool = True, coherent: bool = False):
    """Kernel C: table (N, K) f32; idx (...,) integer in [0, N) →
    (..., K) f32. ``exact=False`` rounds the fetched values to bf16.
    ``coherent``: the caller's indices ascend; a launch is counted under
    (N, K, queries, coherent)."""
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
        _lib.count_launch("row_gather", (n, k, m, int(coherent)))
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


def row_scatter_add(cot, idx, n_rows: int, exact: bool = True,
                    coherent: bool = False, out=None):
    """Kernel C′: Σ over queries of cot rows at idx → (n_rows, K) f32.
    ``exact=False`` rounds each contribution to bf16 before the sum.
    ``coherent=True``: the caller's indices ascend over the rows that are
    not all zero (the padding rows of a compaction carry zeros and any
    index). ``out``: a contiguous (n_rows, K) f32 table that the sums are
    added to in place, instead of a new table of zeros; it is returned."""
    if cot.device.type == "cpu":
        res = row_scatter_add_plain(cot, idx, n_rows, exact)
        return res if out is None else out.add_(res)
    dev = cot.device
    k = cot.shape[-1]
    cf = cot.reshape(-1, k).contiguous()
    ix = idx.reshape(-1).contiguous()
    m = cf.shape[0]
    _lib.expect(cf, "cot", torch.float32, (m, k), dev)
    _lib.expect(ix, "idx", torch.int32, (m,), dev)
    if out is None:
        table = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    else:
        table = out
        _lib.expect(table, "out", torch.float32, (n_rows, k), dev)
    _lib.check(_lib.lib().row_scatter_add_launch(
        cf.data_ptr(), ix.data_ptr(), table.data_ptr(), m, k, n_rows,
        0 if exact else 1, int(coherent), int(out is not None),
        _lib.stream_ptr(cf)), "row_scatter_add")
    # counted by caller family; a coherent launch also says whether it
    # added into a running table
    if coherent:
        _lib.count_launch("row_scatter_add_coherent",
                          (m, k, n_rows, int(out is not None)))
    else:
        _lib.count_launch("row_scatter_add" if exact
                          else "row_scatter_add_bf16", (m, k, n_rows))
    return table


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
    estimator treats them as dead. On the card it is the compaction
    kernel of ``csrc/rowops.cu`` (a count pass and a write pass over
    blocks of 4096 flags, positions written as integers, no atomics).
    ``count`` stays on the device: reading it would stall every chunk."""
    if alive.device.type == "cpu":
        return compact_sel_plain(alive, cap)
    dev = alive.device
    flags = alive.reshape(-1).contiguous()
    m = flags.shape[0]
    _lib.expect(flags, "alive", torch.bool, (m,), dev)
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    if m == 0:
        return (torch.zeros((cap,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    sel = torch.empty((cap,), dtype=torch.int32, device=dev)
    # count, then one count per block of 4096 flags (scratch)
    work = torch.empty((1 + -(-m // 4096),), dtype=torch.int32, device=dev)
    _lib.check(_lib.lib().compact_sel_launch(
        flags.data_ptr(), sel.data_ptr(), work.data_ptr(),
        work.data_ptr() + 4, m, cap, _lib.stream_ptr(flags)), "compact_sel")
    _lib.count_launch("compact_sel", (m, cap))
    return sel, work[0]


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
                               exact=True, coherent=True), None


def gather_coherent_diff(table, sel):
    """Differentiable gather at ascending ``sel`` (the throughput chain
    across a compaction): forward kernel C, backward kernel C′, exact."""
    return _GatherCoherentDiff.apply(table, sel)


class _ScatterAddCoherentInto(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, values, idx):
        ctx.save_for_backward(idx)
        ctx.mark_dirty(acc)
        return row_scatter_add(values.contiguous(), idx, acc.shape[0],
                               exact=True, coherent=True, out=acc)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return cot, row_gather(cot, idx, exact=True, coherent=True), None


def scatter_add_coherent_into(acc, values, idx):
    """``acc`` plus the rows of ``values`` summed at ascending idx,
    computed in place: the rows are added into the running (n_rows, K)
    table ``acc``, which is returned (its earlier value is gone; nothing
    of the backward pass needs it). Forward kernel C′ without a zeroed
    table, backward kernel C for ``values`` and the identity for ``acc``.
    ``acc`` must be contiguous float32 and no view of another tensor."""
    return _ScatterAddCoherentInto.apply(acc, values, idx)


def scatter_add_coherent_diff(n_rows: int, values, idx):
    """Differentiable scatter-add of ``values`` rows into an (n_rows, K)
    zero table at ascending idx: ``scatter_add_coherent_into`` on a fresh
    table. Padding rows must carry zero values."""
    acc = torch.zeros((n_rows, values.shape[-1]), dtype=torch.float32,
                      device=values.device)
    return scatter_add_coherent_into(acc, values, idx)
