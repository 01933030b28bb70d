"""The fused bounce's trace record (``envkernels.bounce_record``, kernel H)
on the CPU: its plain version equals, bit for bit, a frozen copy of the
composition the trace ran inline before the kernel (the taps of the NEE
and of the lobe direction, D′'s pdf of the lobe direction, and the fused
record's packing), on seeded rows with dead and shadowed ones, the poles,
both sides of the u-seam, and broadcast alive flags and normals; the CPU
takes the plain version and counts no launch; the generic record keeps
its own code. The kernel itself is held to the plain version on the card
by ``tests/test_torch_kernels_cuda.py``."""

import math
from types import SimpleNamespace

import pytest
import torch

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops import envmap as em
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.ops.kernels import envkernels as ek
from materialist_tpu_torch.render import shader
from materialist_tpu_torch.render.scene import Materials, make_gbuffer

PI = math.pi
# the poles, both sides of the u-seam (atan2 near ±π) and of u = 0
EDGE_DIRS = [[0, 1, 0], [0, -1, 0], [-1e-7, 0, 1], [1e-7, 0, 1],
             [-1e-7, 0.6, 0.8], [1e-7, -0.6, 0.8], [-1e-7, 0, -1],
             [1e-7, 0, -1], [0, 0.5, 0.5], [1e-30, 0.999999, 1e-3]]


# ------------------------------------------- the frozen inline composition

def _frozen_dir_to_uv(d, height, width):
    phi = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * PI)
    u = (phi - torch.floor(phi)) * width
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    v = theta / PI * height
    return u, v


def _frozen_bilinear_coords(d, h, w):
    u, v = _frozen_dir_to_uv(d, h, w)
    uf = u - 0.5
    vf = v - 0.5
    u0 = torch.floor(uf)
    v0 = torch.floor(vf)
    du = uf - u0
    dv = vf - v0
    u0i = torch.remainder(u0.to(torch.int32), w)
    v0i = torch.clamp(v0.to(torch.int32), 0, h - 1)
    return u0i, v0i, du, dv


def _frozen_pdf_dir(m_pdf, c_pdf, d):
    h, w = c_pdf.shape
    u, v = _frozen_dir_to_uv(d, h, w)
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    sin_theta = torch.clamp_min(torch.sin(theta), 1e-6)
    pdf = (h * w) * (c_pdf[vi, ui] * m_pdf[vi]) / (2.0 * PI * PI * sin_theta)
    return pdf[..., None]


def _frozen_normalize9(v):
    return v / torch.clamp_min(torch.sqrt(torch.sum(v * v, dim=-1,
                                                    keepdim=True)), 1e-9)


def frozen_record(sampler, wi, wi_e, pdf_e, hit, shadowed, base_alive, nrm):
    """(aux, recb, nrm) as the trace composed them inline: the post-march
    taps and pdf, then ``_bounce_record``'s fused branch."""
    eh, ew = sampler.c_pdf.shape
    uv_e = _frozen_bilinear_coords(wi_e, eh, ew)
    pdf_at = _frozen_pdf_dir(sampler.m_pdf, sampler.c_pdf, wi.contiguous())
    uv_b = _frozen_bilinear_coords(wi, eh, ew)
    rec_wi = wi.to(torch.bfloat16)
    rec_pdf_at = pdf_at.to(torch.bfloat16)
    rec_uvi = torch.stack([uv_e[0], uv_e[1], uv_b[0], uv_b[1]], -1)
    rec_uvf = torch.stack([uv_e[2], uv_e[3], uv_b[2], uv_b[3]], -1)
    rec_uvi = rec_uvi.to(torch.int16)
    rec_uvf = rec_uvf.to(torch.bfloat16)
    win = _frozen_normalize9(rec_wi.to(torch.float32))
    tgt = win.shape[:-1]
    gate_nee = (base_alive & ~shadowed).to(torch.float32)
    gate_miss = (base_alive & ~hit).to(torch.float32)
    rec_nrmf = nrm.expand(tgt + (3,)).to(torch.float16)
    rec_aux = torch.cat([win, gate_nee[..., None], gate_miss[..., None]],
                        -1).to(torch.bfloat16)
    rec_recb = torch.cat(
        [pdf_e.to(torch.bfloat16), rec_pdf_at, wi_e.to(torch.bfloat16),
         rec_uvf, rec_uvi.to(torch.bfloat16)], -1)
    return rec_aux, rec_recb, rec_nrmf


# ------------------------------------------------------------- the inputs

def _sampler(seed, h=16, w=32):
    g = torch.Generator().manual_seed(seed)
    env = (torch.rand((h, w, 3), generator=g) + 0.05) ** 4
    return em.build_sampler(env)


def record_inputs(lead, seed, alive_shape, nrm_rows_of):
    """Seeded record inputs over leading axes ``lead``: unit lobe and NEE
    directions (the edge directions first), pdfs, flags with dead,
    shadowed and missed rows, the alive flags at ``alive_shape`` and the
    normals as ``nrm_rows_of(g)`` gives them (both broadcast to lead)."""
    g = torch.Generator().manual_seed(seed)
    m = math.prod(lead)
    wi = torch.nn.functional.normalize(torch.randn((m, 3), generator=g),
                                       dim=-1)
    wi_e = torch.nn.functional.normalize(torch.randn((m, 3), generator=g),
                                         dim=-1)
    edge = torch.tensor(EDGE_DIRS)[:m]
    wi[:len(edge)] = edge
    wi_e[-len(edge):] = edge.flip(0)[:m]
    pdf_e = torch.rand((m, 1), generator=g) * 3.0
    hit = torch.rand((m,), generator=g) < 0.6
    shadowed = torch.rand((m,), generator=g) < 0.3
    alive = torch.rand(alive_shape, generator=g) < 0.8
    return (wi.reshape(lead + (3,)), wi_e.reshape(lead + (3,)),
            pdf_e.reshape(lead + (1,)), hit.reshape(lead),
            shadowed.reshape(lead), alive.expand(lead), nrm_rows_of(g))


def _unit_rows(g, shape):
    return torch.nn.functional.normalize(torch.randn(shape, generator=g),
                                         dim=-1)


# bounce 0 (alive flags and normals a broadcast over the samples), a
# compacted bounce (one leading row, the normals a strided slice of the
# side table's rows), a jittered bounce 0 (everything full) and a batch of
# three leading axes
CASES = {
    "broadcast": ((8, 96), (96,), lambda g: _unit_rows(g, (96, 3))),
    "compacted": ((1, 160), (1, 160),
                  lambda g: _unit_rows(g, (1, 160, 10))[..., 5:8]),
    "full": ((4, 64), (4, 64), lambda g: _unit_rows(g, (4, 64, 3))),
    "three_axes": ((2, 3, 40), (3, 40), lambda g: _unit_rows(g, (40, 3))),
}


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_the_frozen_inline_record(case):
    lead, alive_shape, nrm_of = CASES[case]
    smp = _sampler(3)
    args = record_inputs(lead, 11, alive_shape, nrm_of)
    got = ek.bounce_record_plain(smp.m_pdf, smp.c_pdf, *args)
    want = frozen_record(smp, *args)
    assert [tuple(t.shape) for t in got] == [lead + (5,), lead + (13,),
                                             lead + (3,)]
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float16]
    _equal(got, want)
    aux, recb, _ = got
    # the gates hold dead, shadowed and missed rows both ways
    for col in (3, 4):
        assert set(aux[..., col].float().unique().tolist()) == {0.0, 1.0}
    # the lobe directions' taps reach the last column (the u-seam wraps)
    # and both pole rows
    flat = recb.reshape(-1, 13).float()
    assert flat[:, 11].max() == 31
    assert flat[:, 12].min() == 0 and flat[:, 12].max() == 15


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    lead, alive_shape, nrm_of = CASES["broadcast"]
    smp = _sampler(4)
    args = record_inputs(lead, 12, alive_shape, nrm_of)
    before = dict(_lib.LAUNCHES)
    got = ek.bounce_record(smp.m_pdf, smp.c_pdf, *args)
    assert _lib.LAUNCHES == before
    _equal(got, ek.bounce_record_plain(smp.m_pdf, smp.c_pdf, *args))


def _trace_scene(res=16):
    g = torch.Generator().manual_seed(5)
    depth = 2.0 + 0.3 * torch.rand((res, res), generator=g)
    depth[4:10, 3:12] -= 0.6
    cam = Camera(res, res)
    gb = make_gbuffer(depth, cam, flip_depth=False)
    mats = Materials(0.2 + 0.7 * torch.rand((res, res, 3), generator=g),
                     0.2 + 0.7 * torch.rand((res, res, 1), generator=g),
                     0.5 * torch.rand((res, res, 1), generator=g),
                     gb.normal_geo.clone())
    env = (torch.rand((16, 32, 3), generator=g) + 0.1) * 2
    return cam, gb, mats, env


TRACE_CASES = {
    "compacted": dict(compact_caps=(0.5, 0.25)),
    "jittered": dict(film_jitter=0.5),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_fused_trace_records_equal_the_frozen_record(monkeypatch, case):
    """A fused chunk's trace on the CPU calls ``bounce_record`` once a
    bounce, and each call's records equal the frozen composition on the
    same inputs (bounce 0's broadcast flags and normals, the compacted
    bounces' strided normals)."""
    cam, gb, mats, env = _trace_scene()
    cfg = shader.RenderConfig(spp=4, chunk=2, march_steps=6,
                              shadow_steps=4, **TRACE_CASES[case])
    smp = em.build_sampler(env)
    calls = []

    def checked(m_pdf, c_pdf, *args):
        got = ek.bounce_record(m_pdf, c_pdf, *args)
        _equal(got, frozen_record(smp, *args))
        calls.append(args[0].shape)
        return got
    monkeypatch.setattr(shader, "bounce_record", checked)
    recs = shader._trace_chunk_paths(rng.key(3), cfg, cam, gb, mats, env)
    assert len(calls) == len(recs) == cfg.max_depth - 1
    for rec, shp in zip(recs, calls):
        assert rec.aux.shape[:-1] == shp[:-1]
        assert rec.wi is None and rec.uvi is None


GENERIC = {
    "nee_false": (dict(nee=False), (16, 32)),
    "large_envmap": (dict(), (128, 256)),
}


@pytest.mark.parametrize("case", list(GENERIC))
def test_generic_records_keep_their_own_code(monkeypatch, case):
    """A trace that the fused shade does not take (no NEE; an emitter over
    64 a side) never calls ``bounce_record`` and records the generic
    fields, each as the generic record composes them from the same
    directions."""
    over, (eh, ew) = GENERIC[case]
    cam, gb, mats, _ = _trace_scene()
    env = (torch.rand((eh, ew, 3), generator=torch.Generator().manual_seed(
        6)) + 0.1) * 2

    def refused(*args):
        raise AssertionError("the generic trace called bounce_record")
    monkeypatch.setattr(shader, "bounce_record", refused)
    cfg = shader.RenderConfig(spp=2, chunk=2, march_steps=6,
                              shadow_steps=4, **over)
    recs = shader._trace_chunk_paths(rng.key(4), cfg, cam, gb, mats, env)
    assert len(recs) == cfg.max_depth - 1
    for rec in recs:
        assert rec.aux is None and rec.recb is None
        assert rec.wi.dtype == rec.uvf.dtype == torch.bfloat16
        assert rec.uvi.dtype == torch.int16
        assert rec.uvi.shape[-1] == (4 if cfg.nee else 2)
        assert (rec.pdf_at is not None) == cfg.nee


def test_generic_record_is_the_frozen_generic_composition():
    """``shader._bounce_record`` packs the generic fields as before: bf16
    directions and pdfs, int16 texels, bf16 fractions, in the NEE and the
    NEE-free layouts."""
    lead, alive_shape, nrm_of = CASES["full"]
    smp = _sampler(5)
    wi, wi_e, pdf_e, hit, shadowed, *_ = record_inputs(
        lead, 13, alive_shape, nrm_of)
    eh, ew = smp.c_pdf.shape
    uv_e = _frozen_bilinear_coords(wi_e, eh, ew)
    uv_b = _frozen_bilinear_coords(wi, eh, ew)
    pdf_at = _frozen_pdf_dir(smp.m_pdf, smp.c_pdf, wi)
    h = SimpleNamespace(hit=hit, idx=torch.zeros(lead, dtype=torch.int32))
    blob = torch.ones(lead + (8,), dtype=torch.bfloat16)
    rec = shader._bounce_record(shadowed, h, wi, (wi_e, pdf_e, uv_e, pdf_at),
                                uv_b, blob, None, None)
    assert torch.equal(rec.wi, wi.to(torch.bfloat16))
    assert torch.equal(rec.wi_e, wi_e.to(torch.bfloat16))
    assert torch.equal(rec.pdf_e, pdf_e.to(torch.bfloat16))
    assert torch.equal(rec.pdf_at, pdf_at.to(torch.bfloat16))
    assert torch.equal(rec.uvi, torch.stack(
        [uv_e[0], uv_e[1], uv_b[0], uv_b[1]], -1).to(torch.int16))
    assert torch.equal(rec.uvf, torch.stack(
        [uv_e[2], uv_e[3], uv_b[2], uv_b[3]], -1).to(torch.bfloat16))
    assert rec.aux is None and rec.recb is None and rec.nrm is None
    assert rec.blob is blob and rec.shadowed is shadowed
    rec = shader._bounce_record(shadowed, h, wi, None, uv_b, None, None,
                                None)
    assert rec.pdf_at is None and rec.wi_e is None and rec.pdf_e is None
    assert torch.equal(rec.uvi, torch.stack([uv_b[0], uv_b[1]],
                                            -1).to(torch.int16))
    assert torch.equal(rec.uvf, torch.stack([uv_b[2], uv_b[3]],
                                            -1).to(torch.bfloat16))
