"""Percent of the bytes the sweep copied down that landed in page-locked
host memory: the window's ``download`` spans' ``pinned_bytes`` over
their ``bytes``.  A program whose spans lack ``pinned_bytes`` gives
``None``; a CPU run, which copies nothing down, 0."""
from portbench.span_parts import _in_window


def pinned_share(ctx) -> float | None:
    spans = _in_window(ctx)
    if not spans:
        return None
    downs = [s["args"] for s in spans if s["name"] == "download"
             and "pinned_bytes" in s.get("args", {})]
    total = sum(a["bytes"] for a in downs)
    if not total:
        return None
    return 100.0 * sum(a["pinned_bytes"] for a in downs) / total


def read(ctx):
    return pinned_share(ctx)
