"""The readings that the limits of ``matnet518.finetune``'s check are set
from (not run by the benchmark's own runs): over a list of seeds, the
program's numbers against the plain reference over the set-up's steps, as
a run's check reads them; on fewer seeds, the control's (the reference
with TF32 on for matrix products and convolutions, a lower precision than
the configuration states) and each planted fault's (the reference with
the LPIPS term dropped, with half the batch left out of the loss, and
with the weight decay skipped), each against the reference. A step left
unchanged reads 1 on ``change_gap`` and needs no run.

    python3 perfbench/finetune_readings.py --seeds 11,12,13 \\
        --control-seeds 11 --fault-seeds 11 --out FILE

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
from perfbench.loops import finetune  # noqa: E402
from perfbench.reference import matnet as ref  # noqa: E402

CELL = "matnet518.finetune"


def seed_readings(conf, traffic, seed, dev, control, faults, log=run.log):
    t0 = time.perf_counter()
    loop = finetune.Loop(conf, traffic, seed, dev, log)
    loop.free()
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = dict(seed=seed, program={}, losses=[], setup_s=t1 - t0)
    out.update({v: {} for v in (["control"] if control else [])
                + [f"fault_{f}" for f in faults]})
    for rec in loop.records:
        args = (conf, seed, loop.data, loop.frozen, loop.lpips_sd, rec)
        r = finetune.reference_step(*args)
        out["losses"].append([rec["loss"], r["loss"]])
        nums = {"program": finetune.step_gaps(rec, r)}
        # the worst tensor's gradient gap, which the check does not read
        by_tensor = finetune.tensor_gaps(rec["grads"], r["grads"])
        name = max(by_tensor, key=by_tensor.get)
        if by_tensor[name] >= out.get("worst_grad", [0, "", 0.0])[2]:
            out["worst_grad"] = [rec["i"], name, by_tensor[name]]
        variants = ([("control", dict(tf32=True))] if control else []) + [
            (f"fault_{f}", dict(fault=f)) for f in faults]
        for v, kw in variants:
            x = finetune.reference_step(*args, **kw)
            nums[v] = finetune.gaps(x["loss"], x["grads"], x["change"], r)
        for v, got in nums.items():
            for k, x in got.items():
                out[v][k] = max(out[v].get(k, 0.0), x)
    out["reference_s"] = time.perf_counter() - t1
    if torch.device(dev).type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 perfbench/finetune_readings.py")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    bench = run.load_json("BENCHMARK.json")
    cell = run.cell_of(bench, CELL)
    conf = run.load_json("perfbench", "configs", f"{cell['config']}.json")
    traffic = run.load_json("perfbench", "traffic", f"{cell['traffic']}.json")
    dev = torch.device(args.device)
    rows = []
    for seed in ints(args.seeds):
        row = seed_readings(conf, traffic, seed, dev,
                            seed in ints(args.control_seeds),
                            ref.FAULTS if seed in ints(args.fault_seeds)
                            else ())
        print(json.dumps(row), flush=True)
        rows.append(row)
        with open(args.out, "w") as f:
            json.dump(rows, f)


if __name__ == "__main__":
    main()
