"""What the span readers share: the program's own record of spans and
counters (``apnerf_torch.utils.profiling.record()``), which holds the
traced window's, since the window's profiler turns the recorder on.

A program without the recorder gives no record: the readers then read
nothing (None), and the result line leaves their metrics out.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional


def program_record() -> Optional[Dict]:
    """The program's record, or None where the program has no recorder."""
    try:
        from apnerf_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    return read() if read is not None else None


def spans_of(rec: Optional[Dict], names: Iterable[str]):
    """The record's spans named in ``names``."""
    names = set(names)
    return [s for s in (rec or {}).get("spans", []) if s["name"] in names]


def self_ms(rec: Optional[Dict], names: Iterable[str]) -> Optional[float]:
    """The summed host ms of the record's spans named in ``names``, each
    less the spans opened inside it (its self time); None where there are
    none."""
    names = set(names)
    spans = (rec or {}).get("spans", [])
    own = {s["id"]: s["end_ns"] - s["start_ns"] for s in spans
           if s["name"] in names}
    if not own:
        return None
    for s in spans:
        if s["parent"] in own:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return sum(own.values()) * 1e-6


def budget_fill(rec: Optional[Dict], name: str) -> Optional[float]:
    """100 x the passing samples kept (the sum over rows of min(demand,
    budget)) over the passing budgets, of the counters ``name``; None
    where there are none."""
    c = (rec or {}).get("counters", {})
    kept, budget = c.get(f"{name}.pass_demand"), c.get(f"{name}.pass_budget")
    if not budget:
        return None
    return 100.0 * kept / budget
