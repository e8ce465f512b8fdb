"""A closed-loop sweep of the eGPU: ``traffic["lanes"]`` fresh inputs of
every program a drain, through one ``Fleet(batch_size=
traffic["batch_size"])``, drain after drain until the window ends.
``sim_instr_per_s`` is the steps of every job of the window's drains
over the window's seconds."""
from __future__ import annotations

import sys
import time

from portbench import programs, traffic
from portbench.check import Sample
from portbench.profiling import Slice
from portbench.readers import drain_parts
from portbench.systems import egpu

SYSTEM = "egpu"
CHIPS = (1,)


class Driver(egpu.Driver):

    def setup(self) -> None:
        from repro_torch.fleet.api import Fleet
        t = self.traffic
        self.lanes = t["lanes"]
        self.fleet = Fleet(self.cfg, batch_size=t["batch_size"],
                           trace=self.tracer, device=self.device)
        self.bufs = [None] * len(self.progs)
        warm = programs.Inputs(self.device, self.run.seed, traffic.WARMUP)
        for _ in range(t["warmup_drains"]):
            self._drain(warm)
        self.inputs = programs.Inputs(self.device, self.run.seed,
                                      traffic.WINDOW)
        self.ctx["graph_stats"] = self.graph_stats(self.lanes)
        if self.slice is not None:
            Slice.warm()

    def _drain(self, inputs) -> tuple[list, dict, float]:
        """One drain of fresh inputs: each program's handles, the
        results, and the seconds the client took to draw and submit."""
        t0 = time.perf_counter()
        for p in self.progs:
            self.bufs[p.index] = inputs.draw(p, self.lanes,
                                             self.bufs[p.index])
        handles = [[self.fleet.submit(img, buf[i], threads=p.threads,
                                      tdx_dim=p.tdx_dim)
                    for i in range(self.lanes)]
                   for p, img, buf in zip(self.progs, self.images,
                                          self.bufs)]
        submit_s = time.perf_counter() - t0
        return handles, self.fleet.drain(), submit_s

    def _tally(self, handles, res) -> int:
        """The drain's results into the ledger; returns their steps."""
        steps = 0
        for p, hs in zip(self.progs, handles):
            for h in hs:
                r = res.get(h)
                if r is None:
                    self.ledger.missing += 1
                    continue
                steps += r.steps
                self.tally(p.index, r)
        return steps

    def _hold(self, d: int, handles, res, last: bool) -> None:
        """Keep what the check may hold of drain ``d``: the lanes of
        :func:`traffic.drain_lanes` (copied, as the next drain reuses
        the buffers), and of the last drain every lane (as they are)."""
        for p, hs, buf in zip(self.progs, handles, self.bufs):
            lanes = range(self.lanes) if last and traffic.whole(
                self.traffic, p.steps) else traffic.drain_lanes(
                self.traffic, self.run.seed, d, p.index, self.lanes)
            for lane in lanes:
                r = res.get(hs[lane])
                if r is not None:
                    init, got = buf[lane], r.shared
                    if not last:
                        init, got = init.copy(), got.copy()
                    self.held[(p.index, d, lane)] = Sample(p.index, init,
                                                           got)

    def window(self, seconds: float) -> dict:
        self.held: dict = {}
        steps, d = 0, 0
        t0 = time.perf_counter()
        if self.tracer is not None:
            self.ctx["span_window"] = (self.tracer.now_us(), None)
        while True:
            if self.slice is not None and d == 0:
                self.slice.start()
            t_d = time.perf_counter()
            handles, res, submit_s = self._drain(self.inputs)
            t_t = time.perf_counter()
            steps += self._tally(handles, res)
            now = time.perf_counter()
            # the client's parts (drawing and submitting, tallying) and
            # the program's drain
            print(f"drain {d}: {now - t_d:.3f} s (submit {submit_s:.3f}, "
                  f"drain {t_t - t_d - submit_s:.3f}, tally "
                  f"{now - t_t:.3f})", file=sys.stderr)
            if self.slice is not None and d == 0:
                self.slice.stop()
                self.ctx["profiled_batches"] = [
                    (p.index, self.lanes) for p in self.progs]
            last = now - t0 >= seconds
            if last:
                window_s = now - t0
            self._hold(d, handles, res, last)
            del handles, res
            d += 1
            if last:
                break
        if self.slice is not None:
            self.ctx["profile"] = self.slice.read()
        if self.tracer is not None:
            self.ctx["span_window"] = (self.ctx["span_window"][0],
                                       self.tracer.now_us())
            for i, parts in enumerate(drain_parts(
                    dict(self.ctx, spans=self.tracer.events))):
                print(f"drain {i} by part (s): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in parts.items()),
                    file=sys.stderr)
        self.ctx.update(drains=d, steps=steps, window_s=window_s)
        for p in self.progs:
            for dd, lanes in traffic.sweep_sample(
                    self.traffic, self.run.seed, p.index, p.steps,
                    self.lanes, d).items():
                self.ledger.samples += [
                    self.held[k] for k in ((p.index, dd, x) for x in lanes)
                    if k in self.held]
        self.held = {}
        return {"sim_instr_per_s": steps / window_s}

    def close(self) -> None:
        self.fleet = None
