"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
then `checks`: each compared number beside its limit); the same numbers
are the last lines of standard error. No card, too few cards, or a JAX
module loaded by the end: a non-zero exit and no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that must not be loaded in the process that
#: prints the result (the JAX package and JAX itself)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "scheduler_plugins_tpu"})


def fix_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    fix_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import check, harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.drive(cell, args.seed, args.seconds, bool(args.trace),
                        device, T_START)
    record, numbers = out["record"], out["numbers"]
    metrics = harness.metrics_of(cell, record, bool(args.trace))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": out["peak"]}
    breakdown = None
    if args.trace:
        info["busy_s"] = record.profile["busy_s"]
        info["window_s"] = record.profile["window_s"]
        breakdown = record.profile["breakdown"]
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    its = record.iteration_s
    print(f"portbench: {cell.name} seed {args.seed} cycles "
          f"{numbers['cycles']} compared exactly "
          f"{numbers['cycles_compared_exactly']} window_s "
          f"{record.window_s} setup_parts {record.setup_parts} gc_s "
          f"{record.gc_s} gc_gen2 {record.gc_gen2} check_s "
          f"{record.check_s} first_iterations_s {its[:3]} "
          f"median_iteration_s {statistics.median(its) if its else None} "
          f"last_iterations_s {its[-3:]}", file=sys.stderr)
    for line in check.lines(numbers, cell.config):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"],
                              out["attempted"], out["failed"], metrics,
                              info, breakdown, numbers, cell.config),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
