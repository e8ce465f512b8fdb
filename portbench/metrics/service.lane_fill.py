"""Real jobs over the lanes the service dispatched in the window (its
cohorts are padded to fixed buckets): ``fleet_jobs_total`` over it plus
``fleet_pad_slots_total``, counted by the schedulers."""


def read(ctx):
    jobs, pad = ctx.get("lane_jobs", (0, 0))
    if jobs + pad == 0:
        return None
    return 100.0 * jobs / (jobs + pad)
