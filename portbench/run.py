"""Run one benchmark cell of the PyTorch port on the GPU and print its
result as the last line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights and data from the seed, the model built, every shape the
cell's traffic uses warmed) is timed from the first line of this module to
the window's start as ``setup_s``.  ``--trace 0`` measures the window and
prints the cell's end-to-end metrics; ``--trace 1`` runs the window under
``torch.profiler`` and prints its per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``.  Either way, once the window has closed,
the peak memory is read, the system's state freed and the plain reference
run over what the window produced: every number compared is printed beside
its limit, as the last lines of standard error and under ``check``, the
last key of the result.  Exits non-zero without a result when the cell
needs more GPUs than there are, or when JAX or the JAX package got
loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpmc_tpu")


def cache_env(root: str) -> None:
    """Compile caches at fixed paths inside the checkout; libraries that
    could load JAX by themselves are kept from it."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "portbench", ".cache",
                                                  "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Set up, measure, check; the result as a dict (``correct`` per the
    cell's limits)."""
    import torch

    from portbench import check as checks
    from portbench import spec
    from portbench.counts import PEAKS

    session = spec.driver(cell["driver"]).Session(cell, seed, device)
    session.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    tracer = None
    if trace:
        from portbench.trace import Trace
        tracer = Trace()
    out = session.window(seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    session.release()
    ref = session.reference()
    judged = checks.judge(session.check(ref), cell["limits"])
    units = spec.metric_units()
    if trace:
        ctx = dict(out["layer_ctx"], cfg=cell["config"], trace=tracer,
                   peaks=PEAKS)
        values = {m: spec.metric_reader(m)(ctx) for m in cell["per_layer"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        values = {m: values[m] for m in cell["end_to_end"]}
    metrics = {m: {"value": v, "unit": units[m]} for m, v in values.items()
               if v is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": checks.passed(judged),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        result["breakdown"] = tracer.breakdown()
    if "detail" in out:
        result["detail"] = out["detail"]
    result["check"] = judged
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import spec
    cache_env(spec.ROOT)
    import torch

    cell = spec.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, j in result["check"].items():
        print(f"check {name} {j['value']!r} limit {j['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
