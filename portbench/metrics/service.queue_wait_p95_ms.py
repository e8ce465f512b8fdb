"""The 95th percentile over the requests resolved in the window of the
time each waited for its cohort's dispatch (``queued`` phases, summed
over its attempts)."""
from portbench.span_parts import phase_p95_ms


def read(ctx):
    return phase_p95_ms(ctx, "queued")
