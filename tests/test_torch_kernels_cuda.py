"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes (chip_smoke.py checks them at the main path's shapes), and
the march and the material adjoint at the 1024² bench's chunk. Needs
an NVIDIA GPU: marked ``cuda`` and skipped where there is none. Run on the
card with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``."""

import math
import os

import pytest
import torch

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.models.train import CUBLAS_WORKSPACE
from materialist_tpu_torch.ops import brdf
from materialist_tpu_torch.ops import envmap as em
from materialist_tpu_torch.ops.kernels import envkernels as ek
from materialist_tpu_torch.ops.kernels import gather
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.ops.kernels import rowops
from materialist_tpu_torch.ops.kernels import shadebounce as sb
from materialist_tpu_torch.ops.kernels import vreg_gather as vreg
from materialist_tpu_torch.opt.plan import device_bytes, plan_step
from materialist_tpu_torch.render import screenspace as ss
from materialist_tpu_torch.render import shader
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.utils.seeded import (MARCH_CASES,
                                                march_case_inputs,
                                                march_scene)

pytestmark = pytest.mark.cuda
# MaterialNet's training step is deterministic, which cuBLAS is only with
# this set before its first use
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(card):
    g = torch.Generator().manual_seed(0)
    res = 64
    depth = 2.0 + 0.3 * torch.rand((res, res), generator=g)
    depth[10:30, 20:40] -= 0.8
    cam = Camera(res, res)
    gb = make_gbuffer(depth, cam, flip_depth=False, device=card)
    mats = Materials(0.2 + 0.7 * torch.rand((res, res, 3), generator=g),
                     0.2 + 0.7 * torch.rand((res, res, 1), generator=g),
                     0.5 * torch.rand((res, res, 1), generator=g),
                     gb.normal_geo.cpu())
    mats = Materials(*[m.to(card) for m in mats])
    env = ((torch.rand((16, 32, 3), generator=g) + 0.1) * 2).to(card)
    return cam, gb, mats, env


def test_march_pair(card, scene):
    cam, gb, _, env = scene
    s, n = 2, cam.height * cam.width
    tab = mk.march_tables(gb.dist, gb.valid)
    k = rng.split(rng.key(1), 3)
    wo = gb.wo.reshape(n, 3).expand(s, n, 3)
    dl = brdf.sample_dirs(rng.uniform(k[0], (s, n), card),
                          rng.uniform(k[1], (s, n, 2), card), wo,
                          gb.normal_geo.reshape(n, 3),
                          torch.full((n, 1), 0.5, device=card))
    dn, _ = em.sample_dir(em.build_sampler(env),
                          rng.uniform(k[2], (s, n, 2), card))
    o = gb.position.reshape(n, 3).expand(s, n, 3)
    kw = dict(n_steps=24, fine_steps=6, shadow_steps=16, shadow_fine_steps=2,
              interval_frac=0.05)
    hk, sk = mk.march_pair(cam, tab, o, dl, dn, **kw)
    hp, sp = mk.march_pair_plain(cam, tab, o, dl, dn, t_min_frac=2e-3,
                                 t_max_frac=3.0, bias_frac=4e-3, **kw)
    for a, b in ((hk.hit, hp.hit), (hk.idx, hp.idx), (sk, sp)):
        assert float((a == b).float().mean()) >= 0.999


def test_march_and_material_adjoint_at_the_1024_chunk(card, scene):
    """A and C′'s material adjoint (bf16 payload) at the largest chunk
    of the 1024² × 64 spp bench's plan (8·1024² rays on an 80 GB card),
    as chip_smoke.py's rows at that size: flags equal on >= 99.9% of the
    rays, the scatter of the rays that hit within 1e-5 of its largest
    value."""
    res, n = 1024, 1024 * 1024
    s = plan_step(res, 64, device_bytes(card), max_chunk=8).chunk
    depth, mask = march_scene(res, 0)
    cam = Camera(res, res)
    gb = make_gbuffer(depth, cam, flip_depth=False, mask=mask, device=card)
    tab = mk.march_tables(gb.dist, gb.valid)
    k = rng.split(rng.key(4), 3)
    wo = gb.wo.reshape(n, 3).expand(s, n, 3)
    dl = brdf.sample_dirs(rng.uniform(k[0], (s, n), card),
                          rng.uniform(k[1], (s, n, 2), card), wo,
                          gb.normal_geo.reshape(n, 3),
                          torch.full((n, 1), 0.5, device=card))
    dn, _ = em.sample_dir(em.build_sampler(scene[3]),
                          rng.uniform(k[2], (s, n, 2), card))
    o = gb.position.reshape(n, 3).expand(s, n, 3)
    kw = dict(n_steps=24, fine_steps=6, shadow_steps=16, shadow_fine_steps=2,
              interval_frac=0.05)
    hk, sk = mk.march_pair(cam, tab, o, dl, dn, **kw)
    hp, sp = mk.march_pair_plain(cam, tab, o, dl, dn, t_min_frac=2e-3,
                                 t_max_frac=3.0, bias_frac=4e-3, **kw)
    assert hk.hit.numel() == s * n
    assert 0.01 < float(hp.hit.float().mean()) < 0.99
    for a, b in ((hk.hit, hp.hit), (hk.idx, hp.idx), (sk, sp)):
        assert float((a == b).float().mean()) >= 0.999
    idx = hk.idx.reshape(s * n).int().contiguous()
    cot = torch.randn((s * n, 8), device=card,
                      generator=torch.Generator(card).manual_seed(5))
    cot[:, 5:] = 0.0
    # a vertex that missed has no material, so no cotangent
    # (test_torch_bench.py::test_missed_vertices_carry_no_material_
    # cotangent): noise there would pile millions of terms onto row 0,
    # whose float32 sum differs by its order alone by more than 1e-5 of
    # the largest value
    cot = torch.where(hk.hit.reshape(s * n, 1), cot, 0.0)
    a = rowops.row_scatter_add(cot, idx, n, exact=False)
    b = rowops.row_scatter_add_plain(cot, idx, n, exact=False)
    torch.testing.assert_close(a, b, rtol=1e-5,
                               atol=1e-5 * float(b.abs().max()))


def test_shade_bounce_and_scatter(card, scene):
    cam, gb, mats, env = scene
    cfg = shader.RenderConfig(spp=2, chunk=2, max_depth=3, film_jitter=0.5)
    r0, r1 = shader._trace_chunk_paths(rng.key(2), cfg, cam, gb, mats, env)
    m = r1.aux.shape[0] * r1.aux.shape[1]
    wo_d = -shader._normalize9(r0.aux[..., 0:3].float())
    args = (env.contiguous(), r1.blob.float().reshape(m, 5).contiguous(),
            torch.rand((m, 3), device=card), r1.nrm.reshape(m, 3),
            torch.cat([wo_d.bfloat16(), r1.aux], -1).reshape(m, 8),
            r1.recb.reshape(m, 13))
    for a, b in zip(sb.shade_bounce_fwd(*args),
                    sb.shade_bounce_fwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    ct = [torch.randn((m, 3), device=card) for _ in range(2)]
    # d_blob, d_thr and d_env against the plain composite
    for a, b in zip(sb.shade_bounce_bwd(*args, *ct),
                    sb.shade_bounce_bwd_plain(*args, *ct)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    idx = r0.idx.reshape(m).int().contiguous()
    cot = torch.randn((m, 8), device=card)
    for exact in (True, False):
        a = rowops.row_scatter_add(cot, idx, gb.dist.numel(), exact=exact)
        b = rowops.row_scatter_add_plain(cot, idx, gb.dist.numel(),
                                         exact=exact)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)



def _bounce_records(card, m, h, w, seed):
    """Seeded bounce inputs of m rows at an h×w envmap: the seam, the
    pole, 4,096 rows that tap the same bins in both looks, ~30% of each
    look gated off."""
    g = torch.Generator().manual_seed(seed)

    def unit(n):
        v = torch.randn((n, 3), generator=g)
        return v / v.norm(dim=-1, keepdim=True)

    nrm, wo = unit(m), unit(m)
    wo = torch.where((wo * nrm).sum(-1, keepdim=True) < 0, -wo, wo)
    aux = torch.cat([wo, unit(m), (torch.rand((m, 2), generator=g)
                                   > 0.3).float()], -1)
    uvi = torch.stack([torch.randint(0, w, (m,), generator=g),
                       torch.randint(0, h, (m,), generator=g)] * 2, -1)
    uvi[:1000, 0::2] = w - 1
    uvi[1000:2000, 1::2] = h - 1
    uvi[2000:6096, 0::2] = w // 3
    uvi[2000:6096, 1::2] = h // 2
    recb = torch.cat([torch.rand((m, 2), generator=g) * 3 + 0.05, unit(m),
                      torch.rand((m, 4), generator=g), uvi.float()], -1)
    blob = torch.cat([torch.rand((m, 3), generator=g) * 0.9 + 0.05,
                      torch.rand((m, 1), generator=g) * 0.9 + 0.1,
                      torch.rand((m, 1), generator=g)], -1)
    env = torch.rand((h, w, 3), generator=g) * 2 + 0.1
    args = (env.to(card), blob.to(card),
            (torch.rand((m, 3), generator=g) + 0.1).to(card),
            nrm.to(torch.float16).to(card), aux.to(torch.bfloat16).to(card),
            recb.to(torch.bfloat16).to(card))
    return args, [torch.randn((m, 3), generator=g).to(card)
                  for _ in range(2)]


@pytest.mark.parametrize("h,w", [(16, 32), (64, 64)])
def test_bounce_bwd_sums_the_envmap_gradient(card, monkeypatch, h, w):
    """B′ on 600,001 rows (several passes of its blocks): d_blob
    and d_thr against the plain version, d_env against the float64 sum of
    the same taps (the atomics' order varies, so 1e-5 of the largest bin)
    and the float32 contraction; no d_env without env_grad; and the
    bounce's backward on the card never builds the contraction."""
    args, ct = _bounce_records(card, 600001, h, w, 6)
    d_blob, d_thr, d_env = sb.shade_bounce_bwd(*args, *ct)
    p_blob, p_thr, d_le = sb.shade_bounce_bwd_explicit(*args, *ct)
    for a, b in ((d_blob, p_blob), (d_thr, p_thr)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    ref = sb.denv_taps(h, w, args[5], d_le)
    torch.testing.assert_close(d_env.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(d_env, sb._denv_from_dle(args[0], args[5],
                                                        d_le),
                               rtol=0, atol=1e-5 * float(ref.abs().max()))
    n_blob, _, none = sb.shade_bounce_bwd(*args, *ct, env_grad=False)
    assert none is None and torch.equal(n_blob, d_blob)

    def no_contraction(*a):
        raise AssertionError("the one-hot contraction ran on the card")
    monkeypatch.setattr(sb, "_denv_from_dle", no_contraction)
    env = args[0].clone().requires_grad_()
    out = sb.shade_bounce_fused(env, *args[1:])
    torch.autograd.backward(out, ct)
    torch.testing.assert_close(env.grad.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))

def test_env_kernels(card, scene):
    _, gb, _, env = scene
    smp = em.build_sampler(env)
    tabs = (smp.m_cdf, smp.m_pdf, smp.c_cdf, smp.c_pdf)
    u2 = rng.uniform(rng.key(3), (4096, 2), card)
    for a, b in zip(ek.env_sample_dir(*tabs, u2),
                    ek.env_sample_dir_plain(*tabs, u2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    d = -gb.wo.reshape(-1, 3).contiguous()
    a = ek.env_pdf_dir(smp.m_pdf, smp.c_pdf, d)
    b = ek.env_pdf_dir_plain(smp.m_pdf, smp.c_pdf, d)
    assert float(((a - b).abs() <= 1e-5 * b.abs() + 1e-6).float().mean()) \
        >= 0.999
    u0, v0, du, dv = em.bilinear_coords(d, 16, 32)
    u0, v0 = u0.int().contiguous(), v0.int().contiguous()
    torch.testing.assert_close(ek.env_lookup_bilinear(env, u0, v0, du, dv),
                               ek.env_lookup_bilinear_plain(env, u0, v0, du,
                                                            dv))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
def test_row_gather_and_compact_sel(card, exact):
    g = torch.Generator(device=card).manual_seed(4)
    m, cap = 50000, 30720
    table = torch.randn((m, 6), generator=g, device=card)
    alive = torch.rand((m,), generator=g, device=card) < 0.5
    sel, count = rowops.compact_sel(alive, cap)
    sel_p, count_p = rowops.compact_sel_plain(alive, cap)
    assert torch.equal(sel, sel_p) and int(count) == int(count_p)
    rnd = torch.randint(0, m, (3, 777), generator=g, device=card,
                        dtype=torch.int32)
    for idx in (sel, rnd):
        assert torch.equal(rowops.row_gather(table, idx, exact=exact),
                           rowops.row_gather_plain(table, idx, exact))
    t = table.clone().requires_grad_()
    out = rowops.gather_coherent_diff(t, sel)
    film = rowops.scatter_add_coherent_diff(m, out, sel)
    film.backward(torch.ones_like(film))
    assert torch.equal(film.detach()[sel[:int(count)].long()],
                       table[sel[:int(count)].long()])
    assert torch.isfinite(t.grad).all() and float(t.grad.abs().sum()) > 0


@pytest.mark.parametrize("shadow_only", [False, True],
                         ids=["full", "shadow_only"])
def test_march_single(card, scene, shadow_only):
    cam, gb, _, _ = scene
    s, n = 2, cam.height * cam.width
    tab = mk.march_tables(gb.dist, gb.valid)
    k = rng.split(rng.key(5), 2)
    d = brdf.sample_dirs(rng.uniform(k[0], (s, n), card),
                         rng.uniform(k[1], (s, n, 2), card),
                         gb.wo.reshape(n, 3).expand(s, n, 3),
                         gb.normal_geo.reshape(n, 3),
                         torch.full((n, 1), 0.5, device=card))
    o = gb.position.reshape(n, 3).expand(s, n, 3)
    kw = dict(n_steps=24, fine_steps=6, interval_frac=0.05,
              shadow_only=shadow_only)
    hk = mk.march_single(cam, tab, o, d, **kw)
    hp = ss.march_mip(cam, tab.dist, tab.valid, tab.mip, o, d,
                      mip_factor=tab.mip_f, fine_table=tab.fine,
                      fine_factor=tab.fine_f, **kw)
    for a, b in ((hk.hit, hp.hit), (hk.idx, hp.idx)):
        assert float((a == b).float().mean()) >= 0.999


@pytest.mark.parametrize("shape", [(128, 128), (256, 256), (16, 16, 3)])
def test_table_lookups(card, shape):
    g = torch.Generator(device=card).manual_seed(6)
    tab = torch.randn(shape, generator=g, device=card)
    idx = torch.randint(0, shape[0] * shape[1], (4, 5000), generator=g,
                        device=card, dtype=torch.int32)
    assert torch.equal(gather.onehot_gather(tab, idx),
                       gather.onehot_gather_plain(tab, idx))
    if len(shape) == 2:
        assert torch.equal(vreg.vreg_gather(tab, idx),
                           vreg.vreg_gather_plain(tab, idx))


@pytest.mark.parametrize("case", ["none_alive", "all_alive", "over_cap",
                                  "ragged"])
def test_compact_sel_edge_cases(card, case):
    g = torch.Generator(device=card).manual_seed(7)
    m, cap = {"none_alive": (20480, 1024), "all_alive": (20480, 20480),
              "over_cap": (40960, 1024), "ragged": (30001, 20480)}[case]
    alive = {"none_alive": torch.zeros(m, dtype=torch.bool, device=card),
             "all_alive": torch.ones(m, dtype=torch.bool, device=card)}.get(
                 case, torch.rand((m,), generator=g, device=card) < 0.5)
    for flags in (alive, alive[3:]):       # the second: an unaligned start
        sel, count = rowops.compact_sel(flags, cap)
        sel_p, count_p = rowops.compact_sel_plain(flags, cap)
        assert sel.dtype == torch.int32 and count.dtype == torch.int32
        assert torch.equal(sel, sel_p) and int(count) == int(count_p)


@pytest.mark.parametrize("exact", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 3, 5, 8])
@pytest.mark.parametrize("pattern", ["coherent", "skewed", "small_table"])
def test_row_scatter_add_patterns(card, pattern, k, exact):
    """Ascending live rows with zero padding at index 0; 95% of the rows
    on one index; a table small enough for shared memory. Against the
    plain version, within 1e-5 of the largest entry."""
    g = torch.Generator(device=card).manual_seed(8 + k)
    m, n_rows = 70001, (400 if pattern == "small_table" else 90000)
    cot = torch.randn((m, k), generator=g, device=card)
    if pattern == "coherent":
        live = 50000
        idx = torch.zeros((m,), dtype=torch.int32, device=card)
        idx[:live] = torch.sort(torch.randperm(
            n_rows, generator=g, device=card)[:live]).values.int()
        cot[live:] = 0.0
    else:
        idx = torch.randint(0, n_rows, (m,), generator=g, device=card,
                            dtype=torch.int32)
        idx[torch.rand((m,), generator=g, device=card) < 0.95] = 7
    got = rowops.row_scatter_add(cot, idx, n_rows, exact=exact,
                                 coherent=pattern == "coherent")
    ref = rowops.row_scatter_add_plain(cot, idx, n_rows, exact=exact)
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    if pattern == "coherent":
        base = torch.randn((n_rows, k), generator=g, device=card)
        acc = base.clone()
        out = rowops.row_scatter_add(cot, idx, n_rows, exact=exact,
                                     coherent=True, out=acc)
        assert out.data_ptr() == acc.data_ptr()
        torch.testing.assert_close(out, base + ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_scatter_add_coherent_into(card):
    g = torch.Generator(device=card).manual_seed(9)
    m0, cap = 50000, 20480
    alive = torch.rand((m0,), generator=g, device=card) < 0.3
    sel, count = rowops.compact_sel(alive, cap)
    vals = torch.randn((cap, 3), generator=g, device=card)
    vals[int(count):] = 0.0
    vals.requires_grad_()
    buf = torch.zeros((m0, 3), device=card)
    buf = rowops.scatter_add_coherent_into(buf, vals, sel)
    buf = rowops.scatter_add_coherent_into(buf, 2.0 * vals, sel)
    cot = torch.randn((m0, 3), generator=g, device=card)
    buf.backward(cot)
    ref = rowops.row_scatter_add_plain(vals.detach(), sel, m0)
    torch.testing.assert_close(buf.detach(), 3.0 * ref)
    want = 3.0 * cot[sel.long()]
    torch.testing.assert_close(vals.grad[:int(count)], want[:int(count)])


def test_march_origin_broadcast(card, scene):
    """A pixel's samples share their origin: the broadcast view and its
    full copy give the same marches."""
    cam, gb, _, env = scene
    s, n = 3, cam.height * cam.width
    tab = mk.march_tables(gb.dist, gb.valid)
    k = rng.split(rng.key(11), 3)
    dl = brdf.sample_dirs(rng.uniform(k[0], (s, n), card),
                          rng.uniform(k[1], (s, n, 2), card),
                          gb.wo.reshape(n, 3).expand(s, n, 3),
                          gb.normal_geo.reshape(n, 3),
                          torch.full((n, 1), 0.5, device=card))
    dn, _ = em.sample_dir(em.build_sampler(env),
                          rng.uniform(k[2], (s, n, 2), card))
    o = gb.position.reshape(n, 3).expand(s, n, 3)
    for kw in (dict(n_steps=24, fine_steps=6, shadow_steps=16,
                    shadow_fine_steps=2),
               dict(n_steps=12, fine_steps=3, shadow_steps=8,
                    shadow_fine_steps=0)):
        (ha, sa), (hb, sb_) = (mk.march_pair(cam, tab, x, dl, dn,
                                             interval_frac=0.05, **kw)
                               for x in (o, o.contiguous()))
        assert torch.equal(ha.hit, hb.hit) and torch.equal(ha.idx, hb.idx)
        assert torch.equal(ha.t, hb.t) and torch.equal(sa, sb_)
        hp, sp = mk.march_pair_plain(cam, tab, o, dl, dn, t_min_frac=2e-3,
                                     t_max_frac=3.0, bias_frac=4e-3,
                                     interval_frac=0.05, **kw)
        for a, b in ((ha.hit, hp.hit), (ha.idx, hp.idx), (sa, sp)):
            assert float((a == b).float().mean()) >= 0.999


@pytest.mark.parametrize("case,shadow_only", MARCH_CASES)
def test_march_exits_and_shifts_on_the_card(card, case, shadow_only):
    """The compiled kernel on the rays of the CPU test of the same cases
    (frustum exits, two rising edges, shadow_only, negative pixels): hit
    and idx equal to march_mip on the CPU on every ray, t within 1e-6 + two
    parts in 1e7 of t (an ulp of the largest t is above 1e-6)."""
    cam, tab, o, d, n_steps, fine_steps = march_case_inputs(case, shadow_only)
    kw = dict(n_steps=n_steps, fine_steps=fine_steps, interval_frac=0.05,
              shadow_only=shadow_only)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    ref = ss.march_mip(cam, tab.dist, tab.valid, tab.mip, o, d,
                       mip_factor=tab.mip_f, fine_table=tab.fine,
                       fine_factor=tab.fine_f, **kw)
    on_card = type(tab)(*[x.to(card) if torch.is_tensor(x) else x
                          for x in tab])
    got = mk.march_single(cam, on_card, o.to(card), d.to(card), **kw)
    assert torch.equal(got.hit.cpu(), ref.hit)
    assert torch.equal(got.idx.cpu(), ref.idx)
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=2e-7, atol=1e-6)


# the envmap-sampling kernel: the three launch sizes of the compacted main
# path and a ragged one whose uniforms start off an 8-byte boundary
@pytest.mark.parametrize("hw", [(16, 32), (64, 64)],
                         ids=["16x32", "64x64"])
@pytest.mark.parametrize("m", [1048576, 131072, 65536, 70001])
def test_env_sample_dir_shapes(card, m, hw):
    """Row and column equal to the plain version's on every query; wi and
    pdf equal bit for bit (the kernel's float operations, its sincosf
    included, give what the plain version's give on an H100; chip_smoke.py
    allows 2 units in the last place)."""
    g = torch.Generator(device=card).manual_seed(5)
    env = (torch.rand((*hw, 3), generator=g, device=card) + 0.05) ** 4
    smp = em.build_sampler(env)
    tabs = (smp.m_cdf, smp.m_pdf, smp.c_cdf, smp.c_pdf)
    u2 = rng.uniform(rng.key(m), (m + 1, 2), card)
    if m == 70001:
        u2 = u2.reshape(-1)[1:2 * m + 1].reshape(m, 2)   # 4-byte aligned
    else:
        u2 = u2[:m]
    assert torch.equal(ek.env_sample_texels(*tabs, u2),
                       ek.env_sample_texels_plain(smp.m_cdf, smp.c_cdf, u2))
    wi, pdf = ek.env_sample_dir(*tabs, u2)
    wi_p, pdf_p = ek.env_sample_dir_plain(*tabs, u2)
    assert tuple(wi.shape) == (m, 3) and tuple(pdf.shape) == (m, 1)
    assert torch.equal(wi, wi_p) and torch.equal(pdf, pdf_p)


def test_env_sample_dir_edge_uniforms(card):
    """Uniforms at 0, at 1 - 2^-24 and exactly on CDF values (where the
    count of entries below the uniform must not include the entry
    itself), in every pairing, batched as the tracer batches them."""
    g = torch.Generator(device=card).manual_seed(6)
    env = (torch.rand((16, 32, 3), generator=g, device=card) + 0.05) ** 4
    smp = em.build_sampler(env)
    tabs = (smp.m_cdf, smp.m_pdf, smp.c_cdf, smp.c_pdf)
    edge = torch.tensor([0.0, 1.0 - 2.0 ** -24, 0.5], device=card)
    x0 = torch.cat([edge, smp.m_cdf])
    x1 = torch.cat([edge, smp.c_cdf.reshape(-1)])
    u2 = torch.cartesian_prod(x0, x1).reshape(1, -1, 2).expand(2, -1, 2)
    tex = ek.env_sample_texels(*tabs, u2)
    assert torch.equal(tex, ek.env_sample_texels_plain(smp.m_cdf, smp.c_cdf,
                                                       u2))
    assert int(tex[..., 0].max()) == 15 and int(tex[..., 1].max()) == 31
    wi, pdf = ek.env_sample_dir(*tabs, u2)
    wi_p, pdf_p = ek.env_sample_dir_plain(*tabs, u2)
    assert tuple(wi.shape) == (2, u2.shape[1], 3)
    assert torch.equal(wi, wi_p) and torch.equal(pdf, pdf_p)
    assert torch.isfinite(wi).all() and torch.isfinite(pdf).all()


ENV_EDGE_DIRS = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                 [-1e-7, 0, 1], [1e-7, 0, 1], [-1e-7, 0, -1], [1e-7, 0, -1],
                 [0, 0.5, 0.5]]


@pytest.mark.parametrize("m", [1, 31, 33, 1048576])
def test_env_pdf_dir_shapes(card, m):
    """Kernel D′ against its plain version on seeded unit directions, the
    first of them the poles (dy = ±1) and both sides of the seams at
    dx = 0 (dz > 0 and dz < 0), from a start 12 bytes past an aligned
    one. A direction within an ulp of a texel border may fall in the
    neighbouring texel (torch divides by a scalar on the card as a multiply
    by its reciprocal, the kernel divides), so at most 1 query in 10,000
    may differ, as chip_smoke.py allows; the edge directions may not."""
    g = torch.Generator(device=card).manual_seed(8)
    env = (torch.rand((16, 32, 3), generator=g, device=card) + 0.05) ** 4
    smp = em.build_sampler(env)
    d = torch.nn.functional.normalize(
        torch.randn((m + 1, 3), generator=g, device=card), dim=-1)
    edge = torch.tensor(ENV_EDGE_DIRS, device=card)[:m]
    d[1:1 + len(edge)] = edge
    d = d.reshape(-1)[3:].reshape(m, 3)
    got = ek.env_pdf_dir(smp.m_pdf, smp.c_pdf, d)
    ref = ek.env_pdf_dir_plain(smp.m_pdf, smp.c_pdf, d)
    assert tuple(got.shape) == (m, 1) and torch.isfinite(got).all()
    within = ((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6)[:, 0]
    assert within[:len(edge)].all()
    assert float(within.float().mean()) >= (0.9999 if m > 10000 else 1.0)


def test_env_kernels_refuse_large_tables(card):
    big = torch.rand((65, 32), device=card)
    with pytest.raises(ValueError, match="at most"):
        ek.env_sample_dir(big[:, 0].contiguous(), big[:, 0].contiguous(),
                          big, big, torch.rand((8, 2), device=card))
    with pytest.raises(ValueError, match="at most"):
        ek.env_pdf_dir(big[:, 0].contiguous(), big,
                       torch.rand((8, 3), device=card))


def _gather_tables(table):
    """The table, a ``table[1:]`` view of one row more (its base a row's
    bytes further on) and a view whose base is one float further on (4-
    but not 8- or 16-byte aligned: the float route of every width)."""
    n, k = table.shape
    up = torch.cat([table[:1], table])
    flat = torch.empty(n * k + 1, device=table.device)
    flat[1:] = table.reshape(-1)
    return {"contiguous": table, "row_view": up[1:],
            "float_offset": flat[1:].view(n, k)}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("k", [3, 5, 6, 8, 13, 15, 20])
def test_row_gather_routes(card, k, exact):
    """C bitwise equal to its plain version on every route of a width
    (vector loads where the base allows, floats where it does not; 15 is
    the run-time width), at query counts around a warp's group and past
    2^20, in ascending, descending, uniform and repeated order."""
    g = torch.Generator(device=card).manual_seed(k)
    n = 5000
    base = torch.randn((n, k), generator=g, device=card)
    for name, table in _gather_tables(base).items():
        assert torch.equal(table, base), name
        for m in (1, 31, 33, 4097, 2 ** 20 + 3):
            rnd = torch.randint(0, n, (m,), generator=g, device=card,
                                dtype=torch.int32)
            asc = torch.sort(rnd).values
            few = rnd[torch.randint(0, min(m, 3), (m,), generator=g,
                                    device=card)]
            for order, idx in (("random", rnd), ("ascending", asc),
                               ("descending", asc.flip(0)),
                               ("repeated", few)):
                got = rowops.row_gather(table, idx, exact=exact)
                assert torch.equal(got, rowops.row_gather_plain(
                    table, idx, exact)), (name, m, order)


@pytest.mark.parametrize("k", [15, 20])
def test_row_gather_wide_rows(card, k):
    """The transparent BSDF's (N, 15) table (run-time width) and the
    trace's side table of 20 (compiled in)."""
    g = torch.Generator(device=card).manual_seed(7)
    table = torch.randn((4096, k), generator=g, device=card)
    idx = torch.randint(0, 4096, (3, 5000), generator=g, device=card,
                        dtype=torch.int32)
    for exact in (True, False):
        assert torch.equal(rowops.row_gather(table, idx, exact=exact),
                           rowops.row_gather_plain(table, idx, exact))
    t = table.clone().requires_grad_()
    rowops.row_gather_diff(t, idx).sum().backward()
    counts = torch.bincount(idx.reshape(-1).long(), minlength=4096)
    torch.testing.assert_close(t.grad, counts[:, None].float().expand(-1, k))


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["sequential", "vectorized"])
@pytest.mark.parametrize("case,shadow_only", MARCH_CASES)
def test_exact_march_card_against_cpu(card, case, shadow_only, vectorized):
    """The "exact" march is plain tensor code: on the card it must pick
    the hits it picks on the CPU (>= 99.9% of the flags; t within 1e-4
    where both hit)."""
    cam, tab, o, d, _, _ = march_case_inputs(case, shadow_only)
    kw = dict(n_steps=24, n_refine=5, interval_frac=0.05,
              vectorized=vectorized)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hc = ss.march(cam, tab.dist, tab.valid, o, d, **kw)
    hk = ss.march(cam, tab.dist.to(card), tab.valid.to(card), o.to(card),
                  d.to(card), **kw)
    hit_k = hk.hit.cpu()
    assert float((hit_k == hc.hit).float().mean()) >= 0.999
    both = hit_k & hc.hit
    assert float((hk.idx.cpu() == hc.idx)[both].float().mean()) >= 0.999 \
        or not bool(both.any())
    torch.testing.assert_close(hk.t.cpu()[both], hc.t[both], rtol=1e-4,
                               atol=1e-4)


def test_frozen_train_step_card_against_cpu(card):
    """One step of the frozen recipe (lr 1e-4) of a tiny MaterialNet at
    28×42, batch 2, TF32 off, from the same weights and batch on the card
    and on the CPU: loss terms within 1e-4 relative, each trainable
    gradient within 1e-3 of its tensor's largest, parameters after the
    step equal to AdamW's first step on each device's own gradient, and
    within 1e-5 across devices where the gradients' difference pins that
    step. ``chip_smoke.py`` path 8b holds the reduced net at 224×336 to
    its own gradient bounds, set from its readings: there a float32
    step's gradients lie 1-2e-3 from the exact ones."""
    import copy

    from materialist_tpu_torch.models.dpt import MaterialNet
    from materialist_tpu_torch.models import train as tr

    g = torch.Generator().manual_seed(0)
    net = MaterialNet(features=16, out_channels=(8, 16, 32, 64),
                      layer_idx=(0, 1, 2, 3), embed_dim=48, enc_depth=4,
                      num_heads=2, generator=g)
    with torch.no_grad():
        net.depth_head.scratch.output_conv2[2].bias += 1.0
    n = torch.randn((2, 3, 28, 42), generator=g)
    batch = {"im": torch.rand((2, 3, 28, 42), generator=g),
             "albedo": torch.rand((2, 3, 28, 42), generator=g),
             "roughness": torch.rand((2, 1, 28, 42), generator=g),
             "metallic": torch.rand((2, 1, 28, 42), generator=g),
             "normal": n / n.norm(dim=1, keepdim=True),
             "depth": 0.5 + 4 * torch.rand((2, 1, 28, 42), generator=g)}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", card):
            m = copy.deepcopy(net).to(dev)
            step = tr.make_train_step(m, tr.make_optimizer(m, 1e-4))
            losses = step({k: v.to(dev) for k, v in batch.items()})
            out[str(dev)] = (losses, m)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (lc, mc), (lg, mg) = out["cpu"], out[str(card)]
    for k in lc:
        assert abs(float(lg[k]) - float(lc[k])) <= 1e-4 * abs(float(lc[k])), k
    pc, pg = dict(mc.named_parameters()), dict(mg.named_parameters())
    for k in tr.trainable_names(mc):
        ref = pc[k].grad
        err = float((pg[k].grad.cpu() - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()), k
    # AdamW's first step is p(1 - lr·wd) - lr·g/(|g| + eps): held to that
    # on each device; across devices within 1e-5 where the gradients'
    # difference δ pins it (|g| > 2δ, g² > 10·eps·δ), 2·lr elsewhere
    train = tr.trainable_names(mc)
    p0 = net.state_dict()
    for k, v in mc.state_dict().items():
        vg = mg.state_dict()[k].cpu()
        d = (vg - v).abs()
        if k in train:
            gc, gg = pc[k].grad, pg[k].grad.cpu()
            for p1, gr in ((v, gc), (vg, gg)):
                want = p0[k] * (1 - 1e-6) - 1e-4 * gr / (gr.abs() + tr.EPS)
                assert float((p1 - want).abs().max()) <= 1e-7, k
            delta = float((gg - gc).abs().max())
            free = (gc.abs() <= 2 * delta) | (gc * gc <= 10 * tr.EPS * delta)
            assert float(torch.cat([d[free], d.new_zeros(1)]).max()) \
                <= 2.2e-4, k
            d = d[~free]
        assert float(torch.cat([d.flatten(), d.new_zeros(1)]).max()) \
            <= 1e-5, k


def test_device_trainer_repeats_bit_for_bit(card):
    """Two 10-step runs of the device trainer's step (the reduced net,
    the from-scratch recipe, batch 4 at 224×336) from one seed, at
    PyTorch's default TF32 flags: the losses and the parameters are equal
    bit for bit."""
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import train as tr
    g = torch.Generator().manual_seed(0)
    data = {k: torch.rand((8, c) + tdev.IM_HW, generator=g).to(card)
            for k, c in (("im", 3), ("albedo", 3), ("roughness", 1),
                         ("metallic", 1), ("normal", 3))}
    data["normal"] = 2 * data["normal"] - 1
    data["normal"] /= data["normal"].norm(dim=1, keepdim=True)
    data["depth"] = 500 + 2500 * torch.rand((8, 1) + tdev.IM_HW,
                                            generator=g).to(card)
    runs = []
    for _ in range(2):
        net = tdev.reduced_net(0, card)
        step = tdev.make_device_step(tr.scratch_step(net, 3e-4, 300), data,
                                     4)
        key, losses = rng.key(1), []
        for _ in range(10):
            key, k = rng.split(key)
            losses.append(torch.stack(list(step(k).values())))
        runs.append((torch.stack(losses).cpu(), net.state_dict()))
    (l1, p1), (l2, p2) = runs
    assert bool(torch.isfinite(l1).all())
    assert torch.equal(l1, l2)
    for k, v in p1.items():
        assert torch.equal(v, p2[k]), k


@pytest.mark.parametrize("hw,out", [((37, 37), (16, 24)),
                                    ((37, 37), (37, 37)),
                                    ((5, 5), (3, 4))])
def test_bicubic_scale_card_against_cpu(card, hw, out):
    """The pos-embed interpolation on the card with matmul TF32 allowed,
    against the CPU: value and gradient within 1e-6 of their maxima."""
    from materialist_tpu_torch.ops.resize import bicubic_scale
    g = torch.Generator().manual_seed(sum(out))
    x = torch.randn((1, 384) + hw, generator=g)
    s = tuple((o + 0.1) / i for o, i in zip(out, hw))
    ct = torch.randn((1, 384) + out, generator=g)
    res = {}
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cpu", card):
            xd = x.to(dev).detach().requires_grad_()
            y = bicubic_scale(xd, s)
            y.backward(ct.to(dev))
            res[str(dev)] = (y.detach().cpu(), xd.grad.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for got, ref in zip(res[str(card)], res["cpu"]):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())


@pytest.mark.parametrize("shape,size", [((4, 64, 16, 24), (32, 48)),
                                        ((4, 32, 128, 192), (224, 336))])
def test_bilinear_align_corners_card_against_cpu(card, shape, size):
    """The DPT decoder's upsampling on the card with matmul TF32 allowed:
    the forward equal to the CPU's within 1e-6 of its maximum, and its
    matrix backward too."""
    from materialist_tpu_torch.ops.resize import bilinear_align_corners
    g = torch.Generator().manual_seed(size[0])
    x = torch.randn(shape, generator=g)
    ct = torch.randn(shape[:2] + size, generator=g)
    res = {}
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cpu", card):
            xd = x.to(dev).detach().requires_grad_()
            y = bilinear_align_corners(xd, size)
            y.backward(ct.to(dev))
            res[str(dev)] = (y.detach().cpu(), xd.grad.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for got, ref in zip(res[str(card)], res["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())


# the draws (csrc/threefry.cu) against their int64 plain versions, bit for
# bit: keys from split and fold_in, the 1024² bench's lattice streams (8
# samples of 1,048,576 pixels over 1 or 2 dims), the 512² relight's and
# ragged sizes
_DRAW_KEYS = (rng.key(0), rng.split(rng.key(7), 3)[2],
              rng.fold_in(rng.split(rng.fold_in(rng.key(3), 1), 3)[1], 991))


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device.type == "cuda"
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("s,n,dims", [(8, 1048576, 2), (8, 1048576, 1),
                                      (8, 262144, 2), (8, 262144, 1),
                                      (8, 1023, 1), (3, 1025, 2), (1, 1, 1)])
def test_threefry_lattice(card, s, n, dims):
    from materialist_tpu_torch.ops.kernels import _lib
    gens = shader._LATTICE_G[dims]
    for k in _DRAW_KEYS:
        _lib.reset_launches()
        got = rng.lattice(k, s, n, gens, card)
        assert _lib.LAUNCHES["threefry_draw"] == 1
        assert _lib.LAUNCHES_BY_SHAPE == {
            ("threefry_draw", (n * dims, s, 4, 2)): 1}
        _same_bits(got, rng.lattice_plain(k, s, n, gens))
        _same_bits(got, rng.lattice_plain(k, s, n, gens, card))


@pytest.mark.parametrize("shape", [(1, 1048576, 1), (1, 1048576, 2),
                                   (8, 262144, 2), (1,), (1023,), (1025,),
                                   (3, 7), (5, 33, 3)])
def test_threefry_bits_and_uniform(card, shape):
    from materialist_tpu_torch.ops.kernels import _lib
    n = math.prod(shape)
    for k in _DRAW_KEYS:
        _lib.reset_launches()
        _same_bits(rng.bits(k, shape, card), rng.bits_plain(k, shape))
        _same_bits(rng.uniform(k, shape, card), rng.uniform_plain(k, shape))
        assert _lib.LAUNCHES_BY_SHAPE == {
            ("threefry_draw", (n, 1, 8, 0)): 1,
            ("threefry_draw", (n, 1, 4, 1)): 1}
        _same_bits(rng.uniform(k, shape, card, minval=-3.0, maxval=7.5),
                   rng.uniform(k, shape, minval=-3.0, maxval=7.5))


def test_threefry_randint_and_bernoulli_equal_the_cpu(card):
    from materialist_tpu_torch.ops.kernels import _lib
    # the device trainer's draws reach the kernel: randint two launches of
    # the bits, bernoulli one of the uniforms
    _lib.reset_launches()
    rng.randint(_DRAW_KEYS[1], (4,), 0, 64, card)
    rng.bernoulli(_DRAW_KEYS[1], 0.5, (4,), card)
    assert _lib.LAUNCHES_BY_SHAPE == {("threefry_draw", (4, 1, 8, 0)): 2,
                                      ("threefry_draw", (4, 1, 4, 1)): 1}
    for k in _DRAW_KEYS:
        for shape in ((4,), (1000,)):
            for lo, hi in ((0, 64), (-100, 70000), (-2 ** 31, 2 ** 31 - 1)):
                _same_bits(rng.randint(k, shape, lo, hi, card),
                           rng.randint(k, shape, lo, hi))
            for p in (0.5, 0.1):
                _same_bits(rng.bernoulli(k, p, shape, card),
                           rng.bernoulli(k, p, shape))


# ---- H: the fused bounce's trace record

# the poles, both sides of the u-seam (atan2 near ±π) and of u = 0, and a
# direction whose y clamps
RECORD_EDGE_DIRS = [[0, 1, 0], [0, -1, 0], [-1e-7, 0, 1], [1e-7, 0, 1],
                    [-1e-7, 0.6, 0.8], [1e-7, -0.6, 0.8], [-1e-7, 0, -1],
                    [1e-7, 0, -1], [0, 0.5, 0.5], [0, 1.0000001, 0],
                    [1e-30, 0.999999, 1e-3]]


def _record_inputs(card, lead, alive, nrm, seed):
    """Seeded record inputs on the card over leading axes ``lead``: unit
    lobe and NEE directions with the edge directions at both ends, NEE
    pdfs, hit and shadowed flags; ``alive`` and ``nrm`` as given (the
    trace's broadcasts and views)."""
    g = torch.Generator(device=card).manual_seed(seed)
    m = math.prod(lead)
    wi = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=g, device=card), dim=-1)
    wi_e = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=g, device=card), dim=-1)
    edge = torch.tensor(RECORD_EDGE_DIRS, device=card)
    wi[:len(edge)] = edge
    wi[-len(edge):] = edge.flip(0)
    wi_e[:len(edge)] = edge.flip(0)
    pdf_e = torch.rand((m, 1), generator=g, device=card) * 4.0
    hit = torch.rand((m,), generator=g, device=card) < 0.6
    shadowed = torch.rand((m,), generator=g, device=card) < 0.3
    return (wi.reshape(lead + (3,)), wi_e.reshape(lead + (3,)),
            pdf_e.reshape(lead + (1,)), hit.reshape(lead),
            shadowed.reshape(lead), alive, nrm)


def _unit(card, g, shape):
    return torch.nn.functional.normalize(
        torch.randn(shape, generator=g, device=card), dim=-1)


def _record_case(card, case):
    """raw1024's bounce 0 on the full grid (alive flags and normals a
    broadcast over the 8 samples) and its compacted bounces at 1,048,576
    and 524,288 rows (the padding rows dead, the normals a strided slice
    of the fetched side table), and the relight's jittered bounce 0 (8 ×
    262,144, everything full, invalid pixels dead)."""
    g = torch.Generator(device=card).manual_seed(31)
    if case == "full_grid":
        n = 1048576
        alive = (torch.rand((n,), generator=g, device=card) < 0.9).expand(
            8, n)
        return _record_inputs(card, (8, n), alive, _unit(card, g, (n, 3)),
                              32)
    if case == "relight":
        n = 262144
        alive = torch.rand((8, n), generator=g, device=card) < 0.85
        return _record_inputs(card, (8, n), alive,
                              _unit(card, g, (8, n, 3)), 33)
    cap = {"compacted_1m": 1048576, "compacted_512k": 524288}[case]
    alive = (torch.arange(cap, device=card) < cap - 12345)[None]
    fetched = torch.randn((1, cap, 10), generator=g, device=card)
    fetched[..., 5:8] = _unit(card, g, (1, cap, 3))
    return _record_inputs(card, (1, cap), alive, fetched[..., 5:8], 34)


def _record_bits_equal(got, want):
    names = ("aux", "recb", "nrm")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        diff = (a.view(torch.int16) != b.view(torch.int16))
        cols = diff.reshape(-1, a.shape[-1]).sum(0).tolist()
        assert not any(cols), f"{name}: rows differing by column {cols}"


@pytest.mark.parametrize("case", ["full_grid", "compacted_1m",
                                  "compacted_512k", "relight"])
def test_bounce_record_bit_equal_to_its_plain_version(card, case):
    """H against its plain version run on the card (the composition the
    trace ran before: the PyTorch taps, D′, the casts and cats), bit for
    bit, at raw1024's three row counts and the relight's."""
    from materialist_tpu_torch.ops.kernels import _lib
    smp = em.build_sampler(
        (torch.rand((16, 32, 3), device=card,
                    generator=torch.Generator(card).manual_seed(9)) + 0.05)
        ** 4)
    args = _record_case(card, case)
    _lib.reset_launches()
    got = ek.bounce_record(smp.m_pdf, smp.c_pdf, *args)
    m = args[0].numel() // 3
    # the broadcast flags and normals count at their own sizes
    own = (m // 8, m // 8) if case == "full_grid" else (m, m)
    assert _lib.LAUNCHES_BY_SHAPE == {("bounce_record", (m, 16, 32) + own): 1}
    _lib.reset_launches()
    want = ek.bounce_record_plain(smp.m_pdf, smp.c_pdf, *args)
    assert _lib.LAUNCHES["bounce_record"] == 0
    assert _lib.LAUNCHES["env_pdf_dir"] == 1
    _record_bits_equal(got, want)


def test_bounce_record_trace_chunk_equals_the_plain_path(card, scene,
                                                         monkeypatch):
    """A compacted fused chunk's records on the card with H equal those of
    the plain path (the same trace with ``bounce_record_plain``), field by
    field; H launches once a bounce and D′ not at all."""
    from materialist_tpu_torch.ops.kernels import _lib
    cam, gb, mats, env = scene
    cfg = shader.RenderConfig(spp=8, chunk=4, compact_caps=(0.5, 0.25))
    key = rng.key(21)
    _lib.reset_launches()
    got = shader._trace_chunk_paths(key, cfg, cam, gb, mats, env)
    assert _lib.LAUNCHES["bounce_record"] == cfg.max_depth - 1 == 3
    assert _lib.LAUNCHES["env_pdf_dir"] == 0
    monkeypatch.setattr(shader, "bounce_record", ek.bounce_record_plain)
    _lib.reset_launches()
    want = shader._trace_chunk_paths(key, cfg, cam, gb, mats, env)
    assert _lib.LAUNCHES["bounce_record"] == 0
    assert len(got) == len(want) == 3
    for b, (rg, rw) in enumerate(zip(got, want)):
        for field in shader.BounceRecord._fields:
            x, y = getattr(rg, field), getattr(rw, field)
            if field == "extras":
                assert (x is None) == (y is None), (b, field)
                for xe, ye in zip(x or (), y or ()):
                    assert torch.equal(xe, ye), (b, field)
            elif x is None or y is None:
                assert x is None and y is None, (b, field)
            else:
                assert x.dtype == y.dtype and x.shape == y.shape, (b, field)
                if x.is_floating_point():
                    bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
                    x, y = x.view(bits), y.view(bits)
                assert torch.equal(x, y), (b, field)


# (film h, w, samples, film rows (row0, n_rows) or None, jitter, pos0
# written): siren512's and the relight's trace chunks, slices at the top
# and the bottom edge, the CPU test's odd width, and the shade's call,
# which reads no position
PRIMARY_CASES = {
    "siren512": (512, 512, 4, None, 0.5, True),
    "relight": (512, 512, 8, None, 0.5, True),
    "top_slice": (512, 512, 8, (0, 32), 0.5, True),
    "bottom_slice": (512, 512, 4, (448, 64), 0.25, True),
    "odd_w37": (24, 37, 4, None, 0.5, True),
    "odd_w37_bottom": (24, 37, 8, (19, 5), 0.25, True),
    "shade_no_pos": (512, 512, 4, None, 0.5, False),
}
# uniforms on the taps' edges: the jitter at -r, 0, just below +r
PRIMARY_EDGE_U = [[0.0, 0.0], [0.5, 0.5], [0.99999994, 0.99999994],
                  [0.0, 0.99999994], [0.25, 0.75]]


def _primary_gbuffer(card, h, w):
    """Two depth steps; invalid pixels along the first column, the last
    row and at 5% inside."""
    g = torch.Generator().manual_seed(h * 1000 + w)
    depth = 2.0 + 0.3 * torch.rand((h, w), generator=g)
    depth[h // 5:h // 2, w // 4:w // 2] -= 0.7
    mask = (torch.rand((h, w), generator=g) < 0.05).float()
    mask[:, 0] = 1.0
    mask[-1, :] = 1.0
    return make_gbuffer(depth, Camera(h, w), flip_depth=False, mask=mask,
                        device=card)


@pytest.mark.parametrize("case", list(PRIMARY_CASES))
def test_primary_state_bit_equal_to_its_plain_version(card, case):
    """P against its plain version run on the card (the chain of PyTorch
    operations the trace and the shade ran before), bit for bit in all
    four outputs, on the lattice draw with edge uniforms in its first
    rows; one launch, counted at (rows, h, w, pos0 written)."""
    from materialist_tpu_torch.ops.kernels import _lib
    from materialist_tpu_torch.ops.kernels import primary as pk
    h, w, s, rows, r, pos = PRIMARY_CASES[case]
    gb = _primary_gbuffer(card, h, w)
    cam = Camera(h, w)
    off, n_rows = (0, h) if rows is None else (rows[0] * w, rows[1])
    n = n_rows * w
    u = rng.lattice(rng.key(41), s, n, shader._LATTICE_G[2], card)
    u[0, :len(PRIMARY_EDGE_U)] = torch.tensor(PRIMARY_EDGE_U, device=card)
    _lib.reset_launches()
    got = pk.primary_state(u, gb.dist, gb.normal_geo, gb.valid, off, r, cam,
                           pos)
    assert _lib.LAUNCHES_BY_SHAPE == {
        ("primary_state", (s * n, h, w, int(pos))): 1}
    want = pk.primary_state_plain(u, gb.dist, gb.normal_geo, gb.valid, off,
                                  r, cam)
    assert _lib.LAUNCHES["primary_state"] == 1
    assert (got[1] is None) == (not pos)
    for name, a, b in zip(("nrm_geo0", "pos0", "wo0", "valid0"), got, want):
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        diff = a != b
        assert not diff.any(), f"{name}: {int(diff.sum())} elements differ"
    assert 0 < int(want[3].sum()) < want[3].numel()
