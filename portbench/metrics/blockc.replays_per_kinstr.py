"""CUDA graph replays per 1,000 simulated instructions in the window: each
program's replays a run (``graph_stats``) times its runs (one a drain),
over the steps of every job."""


def read(ctx):
    stats, drains, steps = (ctx.get("graph_stats"), ctx.get("drains"),
                            ctx.get("steps"))
    if not stats or not drains or not steps or any(s is None
                                                    for s in stats):
        return None
    return sum(s["replays"] for s in stats) * drains / (steps / 1000.0)
