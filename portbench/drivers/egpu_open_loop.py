"""Independent users of the eGPU service: requests due on the schedule
of :func:`portbench.traffic.open_loop_schedule` to one
``FleetService(batch_size=traffic["batch_size"])``, each one job.
``request_p95_ms`` is the 95th percentile over every request due in the
window of the time from when it was due to when its future resolved."""
from __future__ import annotations

import sys
import threading
import time

import numpy as np

from portbench import programs, traffic
from portbench.check import Sample
from portbench.profiling import Slice
from portbench.systems import egpu

SYSTEM = "egpu"
CHIPS = (1,)


class Driver(egpu.Driver):

    def setup(self) -> None:
        from repro_torch.fleet.service import FleetService
        t = self.traffic
        self.svc = FleetService(self.cfg, batch_size=t["batch_size"],
                                trace=self.tracer, device=self.device)
        warm = programs.Inputs(self.device, self.run.seed, traffic.WARMUP)
        for _ in range(t["warmup_rounds"]):
            futs = [self.svc.submit(img, warm.draw(p, 1)[0],
                                    threads=p.threads, tdx_dim=p.tdx_dim)
                    for p, img in zip(self.progs, self.images)]
            for f in futs:
                f.result()
        self.ctx["graph_stats"] = self.graph_stats(t["batch_size"])
        self.plan(t["rate_per_s"], self.run.seconds)
        if self.slice is not None:
            Slice.warm()

    def plan(self, rate: float, seconds: float) -> None:
        """The window's requests at ``rate``: their schedule, inputs and
        the ones whose results the check holds word for word
        (:func:`traffic.service_sample`)."""
        self.due, self.prog_of = traffic.open_loop_schedule(
            self.run.seed, rate, seconds, len(self.progs))
        inputs = programs.Inputs(self.device, self.run.seed, traffic.WINDOW)
        self.init = [None] * len(self.due)
        for p in self.progs:
            idx = np.nonzero(self.prog_of == p.index)[0]
            if idx.size:
                rows = inputs.draw(p, idx.size)
                for i, r in zip(idx, rows):
                    self.init[i] = r
        self.keep = traffic.service_sample(
            self.traffic, self.run.seed, self.prog_of, [p.steps for p in self.progs])

    def _done(self, i: int, fut) -> None:
        """A future resolved (on the dispatcher's thread): its time, its
        result's record, and the count the window waits on, which a
        future's own waiters would see before this callback has run."""
        self.resolved[i] = time.perf_counter()
        try:
            err = fut.exception()
            if err is not None:
                self.errors[i] = err
                return
            r = fut.result()
            p = int(self.prog_of[i])
            self.tally(p, r)
            if i in self.keep:
                self.ledger.samples.append(Sample(p, self.init[i],
                                                  r.shared.copy()))
        finally:
            with self.settled:
                self.n_settled += 1
                self.settled.notify_all()

    def window(self, seconds: float) -> dict:
        from repro_torch.fleet.scheduler import FleetStats
        t = self.traffic
        n = len(self.due)
        self.resolved = [None] * n
        self.errors: dict = {}
        self.settled = threading.Condition()
        self.n_settled = 0
        stats = FleetStats(self.svc.metrics)
        before = (stats.jobs, stats.pad_slots)
        # the profiled slice is the window's last seconds: reading the
        # profile takes the host for a while, so it waits for the close
        prof_at = seconds - t["profile_s"]
        late = np.zeros(n)
        queued = np.zeros(n, np.int64)
        t0 = time.perf_counter()
        if self.tracer is not None:
            self.ctx["span_window"] = (self.tracer.now_us(), None)
        profiling = False
        for i in range(n):
            now = time.perf_counter() - t0
            if self.slice is not None and not profiling and now >= prof_at:
                self.slice.start()
                profiling = True
            wait = self.due[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t0 - self.due[i]
            queued[i] = self.svc.pending
            p = self.progs[int(self.prog_of[i])]
            f = self.svc.submit(self.images[p.index], self.init[i],
                                threads=p.threads, tdx_dim=p.tdx_dim)
            f.add_done_callback(lambda fut, i=i: self._done(i, fut))
        rest = seconds - (time.perf_counter() - t0)
        if rest > 0:
            time.sleep(rest)
        self.ctx["queued"] = (queued, self.svc.pending)
        if self.tracer is not None:
            self.ctx["span_window"] = (self.ctx["span_window"][0],
                                       self.tracer.now_us())
        if profiling:
            self.slice.stop()
            self.ctx["profile"] = self.slice.read()
        with self.settled:
            self.settled.wait_for(lambda: self.n_settled == n,
                                  timeout=t["grace_s"])
        end = time.perf_counter()
        lat = np.empty(n)
        for i in range(n):
            ok = self.resolved[i] is not None and i not in self.errors
            lat[i] = (self.resolved[i] if ok else end) - (t0 + self.due[i])
        self.ledger.missing = sum(r is None for r in self.resolved)
        self.ledger.failed = len(self.errors)
        print(f"{n} requests, the generator late by {1e3 * late.max():.3f} "
              f"ms at most, {1e3 * np.percentile(late, 95):.3f} ms at p95",
              file=sys.stderr)
        self.ctx.update(requests=n, late_p95_ms=1e3 * float(
            np.percentile(late, 95)), window_s=seconds,
            lane_jobs=(stats.jobs - before[0],
                       stats.pad_slots - before[1]))
        return {"request_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def close(self) -> None:
        self.svc.close()
        self.svc = None
