"""Seconds the cell's plans spent in warm-up and CUDA graph capture at
set-up: ``capture_s`` of every program's plan at the cell's width."""


def read(ctx):
    stats = ctx.get("graph_stats")
    if not stats or any(s is None for s in stats):
        return None
    return sum(s["capture_s"] for s in stats)
