"""2-D table lookup at flat indices: kernel F of ``csrc/gathers.cu``
(replaces ``materialist_tpu/ops/pallas/gather.py::onehot_gather``).

It reads the min-depth mip and the fine table for
``render/screenspace.py::march_mip`` under ``march_impl="mip"``. The TPU
kernel's hi/lo bf16 split existed to get f32 accuracy out of a matrix
product; a load is exact, so exact values are the contract here. The
plain version is indexing.
"""

from __future__ import annotations

import torch

from materialist_tpu_torch.ops.kernels import _lib


def onehot_gather_plain(table, idx):
    return table.reshape((-1,) + table.shape[2:])[idx.long()]


def onehot_gather(table, idx):
    """table (H, W) or (H, W, C) f32; idx (...,) int32 flat = v·W + u in
    [0, H·W) → f32 (...,) or (..., C). Not differentiable."""
    if table.device.type == "cpu":
        return onehot_gather_plain(table.detach(), idx)
    if table.dim() not in (2, 3):
        raise ValueError(f"table: expected (H, W) or (H, W, C), got "
                         f"{tuple(table.shape)}")
    dev = table.device
    c = table.shape[2] if table.dim() == 3 else 1
    tf = table.detach().contiguous()
    ix = idx.reshape(-1).contiguous()
    m = ix.shape[0]
    _lib.expect(tf, "table", torch.float32, device=dev)
    _lib.expect(ix, "idx", torch.int32, (m,), dev)
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    if m:
        _lib.check(_lib.lib().onehot_gather_launch(
            tf.data_ptr(), ix.data_ptr(), out.data_ptr(), m, c,
            _lib.stream_ptr(tf)), "onehot_gather")
        _lib.LAUNCHES["onehot_gather"] += 1
    return out.reshape(idx.shape + table.shape[2:])
