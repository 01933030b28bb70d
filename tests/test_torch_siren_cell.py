"""The benchmark's ``siren512.inverse`` cell on the CPU at a tiny film
(32², 4 samples a pixel in chunks of 2):

- the plain reference (``perfbench/reference/phase_mlp_rm.py``) draws the
  port's ``PosMLP`` weights from a seed, leaf by leaf, in name and shape,
  and computes the same SIREN;
- three steps of the program's phase (``perfbench/phases/mlp_rm.py``, the
  port's ``make_phase_step`` over ``optimize``'s maps and loss) against the
  reference's, within the cell's limits, which the reference's own control
  (its per-vertex shading in bfloat16) misses;
- ``posmlp.rows.arm`` counts H·W rows under each of a step's two roots,
  nothing with no root open, and none of the envmap net's rows;
- ``_posmlp_flops`` at the published widths, against a count by hooks;
- raw1024's phase runs no matrix product but the CPU's plain version of
  B′'s envmap gradient (the card's kernel B′ sums it itself), so the
  matrix-product kernels of a profiled ``siren512`` step on the card are
  the SIREN's.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from materialist_tpu_torch.models.posmlp import make_brdf_net, make_envmap_net
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.utils import profiling as P
from perfbench import files
from perfbench.loops import inverse
from perfbench.metrics import _posmlp_flops as F
from perfbench.reference import phase_mlp_rm as R
from perfbench.tests.conftest import TINY

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
MATMULS = {"aten::mm", "aten::addmm", "aten::matmul", "aten::bmm",
           "aten::linear"}
# the cell's readers of the SIREN, its host and its device
READERS = ("posmlp.mfu.siren512", "posmlp.gemm_roofline.siren512",
           "phase.host_ms.siren512", "glue.device_ops.inverse",
           "device.idle_share.inverse", "device.peak_gib.inverse")


def _load(*parts):
    with open(os.path.join(ROOT, "perfbench", *parts)) as f:
        return json.load(f)


def _cell(config):
    conf = dict(_load("configs", f"{config}.json"), **TINY)
    return conf, _load("traffic", "inverse.json")


def _log(msg):
    pass


@pytest.fixture(scope="module")
def siren_loop():
    conf, traffic = _cell("siren512")
    return inverse.Loop(conf, traffic, SEED, torch.device("cpu"), _log)


@pytest.mark.parametrize("seed", [0, SEED, 2 ** 31 + 5])
def test_reference_draws_the_ports_weights(seed):
    net = make_brdf_net("arm", torch.Generator().manual_seed(seed))
    ref = R.init_params(_load("configs", "siren512.json")["network"], seed,
                        "cpu")
    got = dict(net.named_parameters())
    assert list(got) == list(ref)
    for k, p in got.items():
        assert p.shape == ref[k].shape, k
        assert torch.equal(p.detach(), ref[k].detach()), k


def test_reference_siren_is_the_ports():
    net_c = _load("configs", "siren512.json")["network"]
    net = make_brdf_net("arm", torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.lin_out.weight.normal_(0.0, 0.05,
                                   generator=torch.Generator().manual_seed(4))
    h = w = 32
    start = torch.rand(h * w, 5, generator=torch.Generator().manual_seed(5))
    params = {k: p.detach() for k, p in net.named_parameters()}
    with torch.no_grad():
        got = net(start)
        want = R.siren(params, start, net_c, h, w)
    assert torch.allclose(got, want, rtol=0, atol=1e-5)
    assert float((got - start).abs().max()) > 1e-2


def test_three_steps_within_the_limits_and_the_control_outside(siren_loop):
    conf, traffic = _cell("siren512")
    limits = _load("limits", "siren512.inverse.json")
    loop = siren_loop
    got = dict(losses=loop.losses, first_grad=loop.first_grad,
               change=loop.change)
    ref = inverse.reference_steps(conf, traffic, loop.inp, SEED, "cpu")
    assert set(ref["first_grad"]) == set(loop.first_grad)
    checks = inverse.compare(got, ref, limits)
    assert set(checks) == set(limits)
    for name, c in checks.items():
        assert c["value"] <= c["limit"], (name, checks)
    # every leaf moved, and the SIREN's hidden layers got gradients after
    # the zero output layer's first step
    assert all(v > 0 for v in loop.change.values())
    assert all(v > 0 for v in ref["grad_norms"][1].values())
    low = inverse.reference_steps(conf, traffic, loop.inp, SEED, "cpu",
                                  dtype=torch.bfloat16)
    lows = inverse.compare(low, ref, limits)
    assert any(c["value"] > c["limit"] for c in lows.values()), lows


def test_rows_counted_under_each_root_and_not_without_one(siren_loop):
    loop = siren_loop
    n = TINY["film"] ** 2
    i = loop.next
    loop.unit(i)
    rows = F.rows_counter(F.network())
    assert rows == "posmlp.rows.arm"
    trace = P.recent("phase.trace_all")[-1]["counts"]
    step = P.recent("phase.step")[-1]["counts"]
    assert trace[rows] == n and step[rows] == n
    ctx = dict(unit="step", unit_ms=[1.0])
    assert F.window_rows(ctx) == (n, n)
    # with no root open the forward is a root of its own and counts nothing
    with torch.no_grad():
        loop.ph.params(torch.zeros(n, 5))
    assert rows not in P.recent("posmlp.forward")[-1]["counts"]
    assert not P._STACK and not P._COUNTS


def test_envmap_net_rows_are_counted_apart():
    env = make_envmap_net(torch.Generator().manual_seed(1))
    with P.span("t.env_root"), torch.no_grad():
        env(torch.zeros(16 * 32, 3))
    counts = P.recent("t.env_root")[-1]["counts"]
    assert counts == {f"{P.POSMLP_ROWS}.envmap": 16 * 32}


def test_flops_at_the_published_widths_equal_a_count_by_hooks():
    net_c = _load("configs", "siren512.json")["network"]
    assert F.forward_macs(net_c) == 197663
    assert F.input_grad_macs(net_c) == 194048
    net = make_brdf_net("arm")
    macs = []
    for m in net.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_hook(lambda mod, a, out: macs.append(
                a[0].shape[0] * mod.in_features * mod.out_features))
    with torch.no_grad():
        net(torch.zeros(1024, 5))
    assert sum(macs) == 1024 * F.forward_macs(net_c)
    assert F.step_flops(net_c, 262144, 262144) == 2 * 262144 * (
        3 * 197663 + 194048)


def test_matmul_filter_sees_only_matrix_products():
    assert F.is_matmul("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128")
    assert F.is_matmul("ampere_sgemm_128x64_nn")
    assert F.is_matmul("void cublasLt::splitKreduce_kernel<32, 16, int>")
    assert not F.is_matmul("void at::native::elementwise_kernel<128, 2>")
    assert not any(F.is_matmul(k) for k in _lib.kernel_names())


def _matmuls(loop):
    """The matrix products of one profiled unit of ``loop``, each with the
    names of the ranges around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.unit(loop.next + 1)
    out = []
    for e in prof.events():
        if e.name in MATMULS:
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            out.append((e.name, chain))
    return out


def test_raw1024_phase_runs_no_matrix_product_and_siren512_does(
        siren_loop, monkeypatch):
    from materialist_tpu_torch.ops.kernels import shadebounce
    plain = shadebounce._denv_from_dle

    def denv_plain(*a):
        with torch.profiler.record_function("t.denv_plain"):
            return plain(*a)
    # B′'s envmap gradient on the CPU: the plain version's one-hot
    # contraction, which the card's kernel B′ sums itself
    monkeypatch.setattr(shadebounce, "_denv_from_dle", denv_plain)
    conf, traffic = _cell("raw1024")
    raw = inverse.Loop(conf, traffic, SEED, torch.device("cpu"), _log)
    found = _matmuls(raw)
    assert all("t.denv_plain" in chain for _, chain in found), found
    siren = [name for name, chain in _matmuls(siren_loop)
             if "t.denv_plain" not in chain]
    # the SIREN's five layers forward in the trace and in the step
    assert siren.count("aten::addmm") >= 10, siren


def _ctx(**kv):
    """A context as ``perfbench/run.py`` hands its readers."""
    return dict(dict(unit="step", unit_ms=[], window_s=0.0, setup_s=1.0,
                     peak_bytes=0, spans={}, profile=None), **kv)


@pytest.mark.parametrize("ctx", [_ctx(), _ctx(unit="pass", unit_ms=[1.0],
                                              window_s=1.0, peak_bytes=1)],
                         ids=["no steps", "another unit"])
@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_where_there_is_nothing(name, ctx):
    assert files.load("metrics", name).read(ctx) is None


def test_device_readers_read_nothing_from_a_cpu_run(siren_loop):
    siren_loop.unit(siren_loop.next + 2)
    cpu = dict(device_ops=0, busy_us=0.0, glue_ops=0, by_name={},
               window_us=1e3)
    ctx = _ctx(unit_ms=[1.0], window_s=1e-3, profile=cpu)
    for name in READERS:
        if name != "phase.host_ms.siren512":
            assert files.load("metrics", name).read(ctx) is None, name
    assert files.load("metrics", "phase.host_ms.siren512").read(ctx) > 0
