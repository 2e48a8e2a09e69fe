"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, tracing in the precision below the
configuration's (``control_dtype``: bfloat16 under float32).

    python3 -m fluxbench.control --workload <cell> --seed <n> [--runs 2]

For each seed it traces the compared cloud ``--runs`` times at the
program's rays in that precision, turns each into the loop body's output
as the program would give it, and judges them against the float32
reference exactly as a benchmark run judges the program. It prints one JSON
line per seed with the compared numbers and their limits. The benchmark's
own runs never run it; a control reads as it should where ``correct`` is
false.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_outputs(spec, config, traffic, cloud, seed, runs, device):
    """[(output, hits per ray, rays)] of ``runs`` control traces of
    ``cloud``, each at the program's rays a point."""
    import torch

    from .run import observed

    setup = spec.setup(config["setup"])
    rpp = int(config["rays_per_point"])
    out = []
    for k in range(runs):
        traced = setup.reference(config, cloud, rpp, seed + 7919 * (k + 1),
                                 device, 1, getattr(torch,
                                                    config["control_dtype"]))
        n_rays = int(traced.rays.sum())
        value = observed(spec, traffic, traced)[0]
        out.append((value.cpu().numpy(), float(traced.hits) / n_rays, n_rays))
    return out


def judge_control(spec, workload, seed, runs, device):
    """(correct, numbers) of the control of ``workload`` at ``seed``."""
    from . import compare, inputs
    from .run import reference_check

    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    _, ref_seed, draw = inputs.seeds(seed)
    clouds = spec.setup(config["setup"]).clouds(config, traffic)
    k = draw % len(clouds)
    outputs = control_outputs(spec, config, traffic, clouds[k], ref_seed + 1,
                              runs, device)
    ref = reference_check(spec, config, traffic, clouds, k, ref_seed, device)
    return compare.judge(ref, outputs, spec.limits(cell["name"]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--runs", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from . import spec as spec_mod

    if not torch.cuda.is_available():
        print("fluxbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = spec_mod.Spec()
    for seed in args.seed:
        t0 = time.perf_counter()
        ok, numbers = judge_control(spec, args.workload, seed, args.runs,
                                    torch.device("cuda", 0))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control_correct": ok,
            "seconds": time.perf_counter() - t0,
            "numbers": {n: {"value": v, "limit": lim}
                        for n, (v, lim) in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
