"""Readings the comparison's limits are set from, for one cell, in one
process on the card:

    python3 -m perfbench.limits --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 [--out FILE]

For each of ``--seeds`` a short run of the cell (the harness's own
``run_cell``: inputs, warm-up, window, the sample compared with the
reference) gives the program's compared numbers; for each of
``--control-seeds`` the control, the reference computed in bfloat16, is
put in the program's place and compared the same way.  The benchmark's
runs never run this.  Prints one JSON line per reading and, with
``--out``, writes them all to ``FILE``.
"""
import argparse
import json
import sys

from perfbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.pin_environment()
    from perfbench import compare, harness
    from perfbench.reference import spgemm as ref

    manifest = harness.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.find_cell(manifest, args.workload)
    run.set_host_malloc(cfg)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    torch.set_num_threads(int(run.THREADS))
    shape = (int(cfg["rows"]), int(cfg["cols"]))
    readings = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        res = harness.run_cell(cfg, traffic,
                               harness.cell_metrics(manifest, args.workload,
                                                    False),
                               seed=seed, seconds=args.seconds,
                               trace_on=False, device="cuda")
        readings.append({"side": "program", "seed": seed,
                         "correct": res["correct"],
                         "calls": res["attempted"],
                         **{k: v["value"] for k, v in res["checks"].items()}})
        print(json.dumps(readings[-1]), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        lanes = harness.make_inputs(cfg, traffic, seed)
        numbers = compare.merge([
            compare.compare(
                ref.spgemm_bf16(lane, lane, shape[1], device="cuda"),
                ref.spgemm(lane, lane, shape[1], device="cuda"), shape[1])
            for lane in lanes])
        readings.append({"side": "control", "seed": seed,
                         "correct": compare.passes(numbers), **numbers})
        print(json.dumps(readings[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": readings}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
