"""Percent of the window's jobs that ran on a compiled tier (blocks or
superblock), by ``JobResult.tier``."""


def read(ctx):
    tiers = ctx.get("tiers")
    if not tiers:
        return None
    done = sum(tiers.values())
    return 100.0 * (tiers.get("blocks", 0)
                    + tiers.get("superblock", 0)) / done
