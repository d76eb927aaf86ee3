"""Model FLOPs of a frame or a step, counted by ``FlopCounterMode`` over the
plain reference at the cell's shapes, so that no kernel of the program can
hide work from the count.  A count is kept in ``bench_port/out/flops/``
under a key made of the configuration, the traffic mix and the loop kind:
only the first run in a checkout pays for it.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Optional

CACHE = Path(__file__).resolve().parent / "out" / "flops"


def key(config: dict, traffic: dict, kind: str) -> str:
    blob = json.dumps([config["model"], config.get("train_batch"),
                       traffic, kind], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def cached(k: str) -> Optional[float]:
    path = CACHE / f"{k}.json"
    if not path.exists():
        return None
    return float(json.loads(path.read_text())["flops"])


def count_into(k: str, fn: Callable, scale: float = 1.0):
    """Run ``fn()`` under ``FlopCounterMode``, keep its total FLOPs times
    ``scale`` under ``k``, and return what ``fn`` returned."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn()
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = CACHE / f"{k}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps({"flops": counter.get_total_flops() * scale}))
    os.replace(tmp, CACHE / f"{k}.json")
    return out
