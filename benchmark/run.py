"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 benchmark/run.py --workload int8-single --seed 12345 \\
        --seconds 51 --trace 0

From the root of a checkout, on a machine with the cell's cards: draws
the cell's weights and requests from ``--seed`` on the card, warms the
entry on the shapes its requests use (all of that is ``setup_s``), serves
the requests for ``--seconds`` (under ``torch.profiler`` with ``--trace
1``), frees the program's state and checks a sample of the window's
outputs against the plain reference. The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result. Without a card,
or with fewer than the cell asks for, it exits 3 and prints no result;
if the process has loaded JAX or the JAX package, it exits 4.

Every cache a run writes (Triton, torch extensions, the CUDA JIT) sits
under ``.bench_cache/`` in the checkout; the port builds its kernels into
its own ``tortoise_tpu_torch/_build/``.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")


def _env() -> None:
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def _metrics(run, specs, here) -> dict:
    from benchmark import harness

    out = {}
    for m in specs:
        v = harness.metric(m["name"], here).read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device, t0: float, config: dict = None,
             mix: dict = None, control: bool = False,
             log=sys.stderr, here: str = None) -> dict:
    """One run of ``cell``; returns the result line's dict, or raises.
    ``config`` and ``mix`` replace the cell's configuration and traffic
    files (the tests' tiny sizes). ``control`` also reads the control's
    numbers on the same requests (``benchmark/calibrate.py``; the
    benchmark's own runs never do). ``here`` is the benchmark's
    directory whose files the run reads (``harness.HERE`` unless a test
    runs a copy)."""
    import torch

    from benchmark import check, harness, trace

    here = here or harness.HERE
    run = harness.Run(cell=cell, config=config or harness.config_of(
        spec, cell, os.path.dirname(here)),
        mix=mix or harness.mix_of(cell, here), seed=seed, device=device)
    fam = harness.family(run.config, here)
    fam.build(run)
    drv = harness.driver(run.mix, here)
    state = drv.setup(run)
    run.setup_s = harness.now() - t0
    if traced:
        prof, win = trace.profiler(), trace.span("window")
        prof.start()
        win.__enter__()

        def stop(inside=True):
            if "traced" not in run.extra:
                t0 = harness.now()
                harness.sync(device)
                win.__exit__(None, None, None)
                prof.stop()
                run.extra["traced"] = len(run.records)
                if inside:  # the profiler's own processing, in the window
                    run.extra["trace_stop_s"] = harness.now() - t0

        run.extra["stop_trace"] = stop
    try:
        drv.window(run, state, seconds)
        harness.sync(device)
        if traced:
            stop(inside=False)
    finally:
        drv.close(state)
    banned = harness.banned_modules()
    if banned:
        raise ImportError(f"the run loaded {banned}")
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    if traced:
        run.trace = trace.reduce(prof)
    key = "per_layer" if traced else "end_to_end"
    metrics = _metrics(run, harness.metrics_of(spec, cell["name"], key),
                       here)

    done = run.done
    served = [drv.served(run, r) for r in done]
    pick = check.sample(served, seed, run.mix["check"]["requests"])
    fam.free(run)
    t_check = harness.now()
    limits = run.mix["check"]["limits"]
    names = run.mix["check"]["numbers"]
    ref = fam.reference(run.config, seed, device)
    nums = check.worst([fam.numbers(ref, served[i], names) for i in pick])
    ctrl_nums = None
    if control:
        ctrl = fam.reference(run.config, seed, device, control=True)
        ctrl_nums = check.worst([fam.control_numbers(ref, ctrl, served[i],
                                                     names) for i in pick])
        del ctrl
    correct = (bool(done) and len(done) == len(run.records)
               and check.verdict(nums, limits))

    out = {
        "correct": correct,
        "attempted": len(run.records),
        "failed": len(run.records) - len(done),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": mem,
                   "card": _card(device)},
        "check_s": harness.now() - t_check,
        "requests_checked": [done[i].request.index for i in pick],
    }
    # each request: index, text length, greedy, the family's fields, s from
    # send (closed loop) or due time (open loop) to result
    out["requests"] = [
        [r.request.index, len(r.request.tokens), r.request.greedy]
        + fam.request_row(r)
        + [None if r.end is None else r.end - (r.due or r.start)]
        for r in run.records]
    if ctrl_nums is not None:
        out["control"] = ctrl_nums
    if "generator_late_s" in run.extra:
        out["generator_late_s"] = run.extra["generator_late_s"]
    if traced:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps}
    for r in run.records:
        if r.error:
            print(f"request {r.request.index} failed: {r.error}", file=log)
    for k in sorted(set(nums) | set(limits)):
        print(f"check {k} {nums.get(k)} limit {limits.get(k)}", file=log)
    out["check"] = {k: {"value": nums.get(k), "limit": limits.get(k)}
                    for k in sorted(set(nums) | set(limits))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.cell(spec, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        out = run_cell(spec, cell, args.seed, args.seconds,
                       bool(args.trace), device, T0)
    except ImportError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 4
    banned = harness.banned_modules()
    if banned:
        print(f"refused: the run loaded {banned}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
