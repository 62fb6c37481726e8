#!/usr/bin/env python3
"""Run one cell of the benchmark of hevcasm_tpu_torch on one NVIDIA H100.

    python3 hevcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (its "file": the coded frame,
the EncodeConfig fields and the entry points it names, entries/<name>.py
with reference/<name>.py) and a traffic mix (mixes/<traffic>.json: its
driver, the entry point the driver calls, content and check sample), each
found by name (lookup.py).  A run:

1. builds the port's CUDA library, or loads it from build/hevcasm_tpu_torch/
   in this checkout (only a checkout's first run compiles);
2. makes its frame pool on the card from --seed (content.py);
3. codes what the mix's driver puts in set-up and warms the cell's shapes;
4. measures for --seconds: calls of the driver's step until one begins
   after --seconds, the window closing at the end of the last;
5. with --trace 1, profiles a further fixed number of steps;
6. reads the peak device memory, frees the program's state, and checks a
   seeded sample of the window's outputs against the plain reference
   (reference/), each compared number beside its limit on standard error;
7. prints one JSON line: the cell's end-to-end metrics (--trace 0) or its
   per-layer metrics (--trace 1), each read by metrics/<name>.py.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program, or if JAX or the JAX package
was loaded.  ``--encoder control`` puts the reference computed with
bfloat16 products in the program's place (the control that must come out
not correct).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "hevcbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "hevcasm_tpu")
if sys.path[0] == str(BENCH):
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of this checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_cell(name: str, dirs=None):
    """(benchmark, cell, configuration, mix) of a cell: BENCHMARK.json's,
    with the cells of any ``cells.json`` (the same keys) in ``dirs`` added,
    the configuration from its "file", the mix found by name in ``dirs``."""
    from hevcbench import lookup

    dirs = dirs or lookup.DIRS
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in dirs:
        more = Path(d) / "cells.json"
        if more.is_file():
            extra = json.loads(more.read_text())
            bench = {**bench, "configs": bench["configs"] + extra["configs"],
                     "workloads": bench["workloads"] + extra["workloads"]}
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    if cell["config"] not in files:
        raise KeyError(f"cell {name!r} names no configuration of BENCHMARK.json")
    config = json.loads((ROOT / files[cell["config"]]).read_text())
    mix = json.loads(lookup.find("mixes", cell["traffic"], ".json", dirs).read_text())
    return bench, cell, config, mix


def reader(metric: str):
    """The metric's reader: metrics/<name>.py, else metrics/<stem>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"hevcbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {metric!r} in {BENCH / 'metrics'}")


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: end-to-end ones with tracing
    off, per-layer ones with it on; a metric without a "workloads" list
    belongs to every cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def launch_counts() -> dict:
    """The program's launch counter of each kernel that roofline/ knows."""
    counts = {}
    for path in sorted((BENCH / "roofline").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"hevcbench.roofline.{path.stem}")
        owner, fn = mod.COUNTER
        counts[path.stem] = getattr(getattr(importlib.import_module(owner), fn), "launches")
    return counts


def merge(base: dict, extra: dict | None) -> dict:
    """``base`` with ``extra`` merged in, nested objects key by key."""
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             tiers: str = "ALL", api=None, overrides: dict | None = None,
             dirs=None) -> tuple[dict, list[str]]:
    """One run of a cell.  Returns (the result line's object, the check
    lines for standard error).  ``api`` replaces the program (the control,
    or a broken program in the tests); ``overrides`` are merged into the
    configuration and the mix ({"config": {...}, "mix": {...}}), for the
    tests' tiny sizes on the CPU; ``dirs`` are where cells, mixes, drivers
    and entry points are found (``lookup.DIRS``: the benchmark's own)."""
    import torch

    from hevcbench import content, lookup, profiling
    from hevcbench.program import Program
    from hevcbench.record import Record
    from hevcbench.reference.encoder import Reference

    dirs = dirs or lookup.DIRS
    bench, cell, config, mix = load_cell(workload, dirs)
    config = merge(config, (overrides or {}).get("config"))
    mix = merge(mix, (overrides or {}).get("mix"))
    enc = config["encode"]
    named = config.get("entries", [])
    # Both sides of every named entry point, and the fields the reference
    # codes, are checked before set-up.
    reference = Reference(enc, entries=named, dirs=dirs)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from hevcasm_tpu_torch.kernels import build

        build.load()
    if api is None:
        api = Program(enc, tiers, named, dirs)
    pool = content.make_pool(config["width"], config["height"], config["coded_height"],
                             mix["content"], seed, dev)
    geometry = {"width": config["width"], "coded_height": config["coded_height"],
                "ctu": enc.get("ctu", 64), "search_range": enc["search_range"]}
    ctus_per_frame = (geometry["coded_height"] // geometry["ctu"]) * (
        geometry["width"] // geometry["ctu"])
    ctx = SimpleNamespace(config=config, mix=mix, pool=pool, api=api, seed=seed,
                          ctus_per_frame=ctus_per_frame)
    driver = lookup.module(lookup.find("drivers", mix["driver"], dirs=dirs)).Driver(ctx)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0

    spans: list = []
    ctus = steps = 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        ctus += driver.step(spans)
        steps += 1
    window_s = time.perf_counter() - w0
    rec = Record(geometry, setup_s, window_s, ctus, steps * driver.frames_per_step, spans)

    if trace:
        n = mix["trace_steps"]
        before = launch_counts()
        rec.trace = profiling.profile(lambda: [driver.step(None) for _ in range(n)], cuda)
        after = launch_counts()
        rec.trace.frames = n * driver.frames_per_step
        rec.trace.launches = {k: after[k] - before[k] for k in after}

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c0 = time.perf_counter()
    checks = driver.check(reference)
    check_s = time.perf_counter() - c0

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": checks.correct, "attempted": rec.frames, "failed": checks.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s()
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.numbers.items()}
    lat = sorted(rec.span_s("frame") or rec.span_s("gop"))
    lines = [f"window: {steps} steps, {rec.frames} frames in {window_s} s; a step "
             f"{1e3 * window_s / max(steps, 1)} ms (min {1e3 * lat[0]}, median "
             f"{1e3 * lat[len(lat) // 2]}, max {1e3 * lat[-1]}); the check took {check_s} s",
             f"checked {checks.checked} answers, {checks.failed} wrong"]
    lines += [f"check {k}: {v} (limit {lim})" for k, (v, lim) in checks.numbers.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--encoder", choices=("program", "control"), default="program")
    args = ap.parse_args(argv)
    set_cache_dirs()
    try:
        _, cell, config, _ = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"hevcbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hevcbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import hevcasm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"hevcbench: the program is missing: {e}", file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    api = None
    if args.encoder == "control":
        from hevcbench.reference.encoder import Reference

        api = Reference(config["encode"], dtype=torch.bfloat16,
                        entries=config.get("entries", []))
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), api=api)
    found = sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
    if found:
        print(f"hevcbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 5
    for line in lines:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
