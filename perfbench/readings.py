"""The readings that the limits of a cell's check are set from (not run
by the benchmark's own runs): over a list of seeds, the program's numbers
against the plain reference, as a run's check reads them; on fewer
seeds, the control's (the reference computed with its per-vertex shading
in bfloat16, and TF32 matrix products) and each planted fault's (the
reference with half its chunks left out, with one chunk's image doubled,
and for passes a stale image in place of a fresh one). A step left
unchanged reads 1 on ``change_gap`` and needs no run.

    python3 perfbench/readings.py --workload raw1024.inverse \\
        --seeds 1,2,3 --control-seeds 1 --fault-seeds 1 --out FILE

Prints one JSON line a seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

import torch  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.loops import inverse, relight  # noqa: E402


def _free(loop, dev):
    loop.free()
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def inverse_seed(conf, traffic, seed, dev, control, faults):
    t0 = time.perf_counter()
    loop = inverse.Loop(conf, traffic, seed, dev, run.log)
    got = dict(losses=loop.losses, first_grad=loop.first_grad,
               change=loop.change)
    _free(loop, dev)
    t1 = time.perf_counter()
    ref = inverse.reference_steps(conf, traffic, loop.inp, seed, dev)
    t2 = time.perf_counter()
    out = dict(seed=seed, program=_values(inverse.compare(got, ref, {})),
               program_s=t1 - t0, reference_s=t2 - t1, got=got,
               ref={k: ref[k] for k in ("losses", "first_grad", "change")})
    if control:
        low = inverse.reference_steps(conf, traffic, loop.inp, seed, dev,
                                      dtype=torch.bfloat16)
        out["control"] = _values(inverse.compare(low, ref, {}))
    for f in faults:
        bad = inverse.reference_steps(conf, traffic, loop.inp, seed, dev,
                                      fault=f)
        out[f"fault_{f}"] = _values(inverse.compare(bad, ref, {}))
    return out


def relight_seed(conf, traffic, seed, dev, control, faults):
    t0 = time.perf_counter()
    loop = relight.Loop(conf, traffic, seed, dev, run.log)
    passes = list(range(1, 1 + traffic["check_passes"]))
    for i in passes:
        loop.unit(i)
    images = dict(loop.images)
    _free(loop, dev)
    t1 = time.perf_counter()
    refs = {i: relight.reference_image(conf, traffic, loop.inp,
                                       loop.pass_seed(i)) for i in passes}
    t2 = time.perf_counter()
    out = dict(seed=seed, program=dict(image_gap=max(
        relight.image_gap(images[i], refs[i]) for i in passes)),
        program_s=t1 - t0, reference_s=(t2 - t1) / len(passes))

    def worst(make):
        return dict(image_gap=max(relight.image_gap(
            make(i).cpu().numpy(), refs[i]) for i in passes))

    if control:
        out["control"] = worst(lambda i: relight.reference_image(
            conf, traffic, loop.inp, loop.pass_seed(i), torch.bfloat16))
    for f in faults:
        if f == "unchanged":
            out["fault_unchanged"] = dict(image_gap=max(
                relight.image_gap(refs[passes[0]].cpu().numpy(), refs[i])
                for i in passes[1:]))
            continue
        out[f"fault_{f}"] = worst(lambda i: relight.reference_image(
            conf, traffic, loop.inp, loop.pass_seed(i), fault=f))
    return out


def _values(checks):
    return {k: c["value"] for k, c in checks.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 perfbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    bench = run.load_json("BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    conf = run.load_json("perfbench", "configs", f"{cell['config']}.json")
    traffic = run.load_json("perfbench", "traffic", f"{cell['traffic']}.json")
    one = inverse_seed if traffic["loop"] == "inverse" else relight_seed
    faults = (("half", "altered") if traffic["loop"] == "inverse"
              else ("half", "altered", "unchanged"))
    dev = torch.device(args.device)
    rows = []
    for seed in ints(args.seeds):
        row = one(conf, traffic, seed, dev, seed in ints(args.control_seeds),
                  faults if seed in ints(args.fault_seeds) else ())
        print(json.dumps(row), flush=True)
        rows.append(row)
        with open(args.out, "w") as f:
            json.dump(rows, f)


if __name__ == "__main__":
    main()
