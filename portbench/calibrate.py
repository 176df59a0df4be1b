"""Readings that the check's limits are set from, for one cell, several
seeds in one process (no timed window for training; a short one at the
cell's own load for scoring):

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--fault <name>] [--control] [--seconds 8] [--dump <dir>]

For each seed one JSON line: the system's numbers (or, with ``--fault``,
those of the system with that fault planted, ``portbench/faults.py``),
and with ``--control`` the control's: the reference in float8 in the
system's place; each judged against the cell's limits as a run judges
it (``correct``, ``control_correct``)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--dump", default=None,
                   help="a directory for each training seed's logits")
    args = p.parse_args(argv)

    from portbench import check, spec
    from portbench.faults import FAULTS
    from portbench.run import cache_env
    cache_env(spec.ROOT)
    import torch

    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    torch.set_num_threads(4)
    for seed in [int(s) for s in args.seeds.split(",")]:
        plant = (FAULTS[args.fault]() if args.fault
                 else contextlib.nullcontext())
        session = spec.driver(cell["driver"]).Session(cell, seed, device)
        t0 = time.perf_counter()
        with plant:
            session.setup()
            if cell["driver"] == "predict":
                session.window(args.seconds)
        session.release()
        t1 = time.perf_counter()
        ref = session.reference()
        t2 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "program": session.check(ref)}
        if cell["driver"] == "train":
            line["detail"] = check.train_detail(session.port, ref,
                                                session._valid())
        if args.control and cell["driver"] == "train":
            from portbench.reference.nets import CONTROL
            ctl = session.reference(CONTROL)
            line["control"] = check.train_gaps(ctl, ref, session._valid())
        elif args.control:
            line["control"] = session.control(ref)
        if args.dump and cell["driver"] == "train":
            import numpy as np
            os.makedirs(args.dump, exist_ok=True)
            np.savez(os.path.join(args.dump, f"{args.workload}_{seed}.npz"),
                     port=np.stack(session.port["logits"]),
                     ref=np.stack(ref["logits"]),
                     valid=np.stack(session._valid()),
                     **({"control": np.stack(ctl["logits"])}
                        if args.control else {}))
        line["correct"] = check.passed(check.judge(line["program"],
                                                   cell["limits"]))
        if args.control:
            line["control_correct"] = check.passed(
                check.judge(line["control"], cell["limits"]))
        line["seconds"] = {"setup": t1 - t0, "reference": t2 - t1,
                           "control": time.perf_counter() - t2}
        print(json.dumps(line), flush=True)
        del session, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
