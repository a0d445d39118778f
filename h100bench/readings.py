"""The readings a cell's limits are set from (PERF.md gives them): the
program's numbers compared, over many seeds, and two controls' at the
cell's own size, each through the whole of a short run: the plain reference
in the configuration's control_dtype put in the program's place, and the
program's own lower-precision path, the same call with fewer moduli. The
benchmark's own runs never run a control.

    python3 -m h100bench.readings --workload <cell> --seconds 2 \
        --seeds 1 2 ... --control-seeds 7 8 9 --fewer-moduli 15 14 13

One JSON line per run: side, seed, correct, and each check's value.
"""
from __future__ import annotations

import argparse
import copy
import json

import torch

from h100bench import run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fewer-moduli", type=int, nargs="*", default=[],
                    help="read the program at these num_moduli on the "
                         "control seeds")
    args = ap.parse_args(argv)
    run.set_caches()
    spec = run.cell_spec(args.workload)
    run.check_card(spec["cell"]["chips"])
    control = run.reference_module(spec).control(spec["config"],
                                                 spec["traffic"])
    sides = [("program", spec, args.seeds, None),
             ("control", spec, args.control_seeds, control)]
    for nu in args.fewer_moduli:
        fewer = copy.deepcopy(spec)
        fewer["config"]["num_moduli"] = nu
        sides.append((f"program-nu{nu}", fewer, args.control_seeds, None))
    for side, side_spec, seeds, call in sides:
        for seed in seeds:
            result, checks = run.run(side_spec, seed, args.seconds, False,
                                     "cuda", call=call)
            print(json.dumps({"cell": args.workload, "side": side,
                              "seed": seed, "correct": result["correct"],
                              "attempted": result["attempted"],
                              **{k: c["value"] for k, c in checks.items()}}),
                  flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
