"""The benchmark's driver: a cell from ``BENCHMARK.json`` run end to end.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the number, or None
where there is nothing to read) and ``limits/<workload>.json`` (the limit
of each number the check compares).  Adding a cell, a mix or a metric is
adding such files and entries.

A run: set-up (the program built with the seed's weights, the inputs made
on the card, every shape warmed; its seconds are ``setup_s``), the window
(``--seconds`` of frames or steps; with ``--trace 1`` the first
``traced_items`` of them under the profiler), then, with the program's
state freed, the check against the plain reference.  The last line of
standard output is the result.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench_port import trace as tracing
from bench_port.loops import loop_for

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dhd_tpu")


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, spec: dict, workload: str, here: Path = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.name = workload
        self.spec = cells[workload]
        self.config = json.loads(
            (here / "configs" / f"{self.spec['config']}.json").read_text())
        self.traffic = json.loads(
            (here / "traffic" / f"{self.spec['traffic']}.json").read_text())
        self.limits = json.loads(
            (here / "limits" / f"{workload}.json").read_text())
        self.here = here

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"bench_port_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    return Cell(json.loads((root / "BENCHMARK.json").read_text()), workload)


class Context:
    """What a per-layer metric reads: the device's trace of the traced
    stretch (``trace``, its ``items`` frames or steps), the trace of a
    second, shorter stretch with the host's side and the loop's ranges
    (``detail``), the loop (its configuration ``cfg``, the rig and
    inputs), the seconds per item of the untraced rest of the window
    (``item_s``) and the model FLOPs of an item (``model_flops``)."""

    def __init__(self, loop, trace, detail, item_s: float):
        self.loop = loop
        self.cfg = loop.cfg
        self.kind = loop.kind
        self.trace = trace
        self.detail = detail
        self.items = trace.items
        self.item_s = item_s

    def model_flops(self) -> Optional[float]:
        return self.loop.flops_per_item()


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _e2e(cell: Cell, loop, window_s: float, setup_s: float,
         peak: int) -> Dict[str, Dict]:
    """The end-to-end metrics of the untraced window."""
    lat = sorted(loop.latencies)
    values = {
        "setup_s": setup_s,
        "peak_mem_gb": peak / 1e9,
        "frame_ms": 1e3 * window_s / max(loop.done, 1),
        "step_ms": 1e3 * window_s / max(loop.done, 1),
        "frame_p95_ms": (1e3 * statistics.quantiles(lat, n=20)[-1]
                         if len(lat) >= 2 else float("nan")),
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """Each number that has a limit beside it, and whether every one of
    them is within its limit: the run's ``correct``."""
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items() if name in limits}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, fault: Optional[str] = None,
             log=None) -> dict:
    """One run of ``cell`` on ``device``: the result object the command
    prints.  ``fault`` plants one of :data:`loops.FAULTS` in the timed
    path (the check must then read false); the command line offers none.
    ``device`` may be the CPU for a test at a small configuration: then no
    number of the result is a device number."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    loop = loop_for(cell.config, cell.traffic, seed, device, fault)
    loop.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    # what set-up made stays for the process's life, as in a server that
    # has loaded its model: out of the collector's way, so that a
    # collection walks what the frames or steps allocate and not the model
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    tr = detail = None
    if trace:
        fn = tracing.traced if on_card else _host_trace
        tr = loop.run_traced(cell.traffic["traced_items"], fn)
        detail = loop.run_traced(cell.traffic["detail_items"], fn, host=True)
    # a traced run times a whole window after its traced stretches
    untraced_from, done_before = time.perf_counter(), loop.done
    end = loop.run_until((untraced_from if trace else start) + seconds,
                         min_items=cell.traffic.get("compared_frames", 1))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    gc.unfreeze()
    window_s = end - start
    item_s = (end - untraced_from) / max(loop.done - done_before, 1)
    log(f"window {window_s:.3f} s, {loop.done} items")
    lat = loop.latencies
    if len(lat) >= 8:
        q = len(lat) // 4
        log("latency ms by quarter of the window, median: " + ", ".join(
            f"{1e3 * statistics.median(lat[i * q:(i + 1) * q]):.2f}"
            for i in range(4)))

    loop.release()
    numbers = loop.check(count_flops=trace)
    checks, correct = judge(numbers, cell.limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": loop.done,
              "failed": 0, "metrics": {}, "device": device_info}
    if trace:
        ctx = Context(loop, tr, detail, item_s)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_kernels(10),
                               "idle_gaps": detail.idle_gaps(10)}
    else:
        result["metrics"] = _e2e(cell, loop, window_s, setup_s, peak)
    if on_card:
        log(f"card: {power_limit()}")
    for note in getattr(loop, "notes", ()):
        log(note)
    for name in sorted(set(numbers) - set(checks)):
        log(f"reading {name} {numbers[name]!r} (no limit)")
    result["checks"] = checks
    return result


class _HostTrace(tracing.Trace):
    """A stretch traced on the CPU (tests): the host's operators stand in
    for the kernels, so that the readers have something to read; no
    number of it is a device number."""

    def __init__(self, prof, items: int, window_s: float):
        self.items, self.window_s = items, window_s
        self.host = []
        self._host_starts = []
        self.kernels = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.name.startswith("aten::"))
        self.spans = {}
        self._starts = [k[0] for k in self.kernels]


def _host_trace(run, items: int, host: bool = False):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        run()
        window_s = time.perf_counter() - t0
    return _HostTrace(prof, items, window_s)


def loaded_forbidden() -> List[str]:
    """Modules of JAX, flax or the JAX package in this process, by whole
    top-level name (``dhd_tpu_torch`` is not ``dhd_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
