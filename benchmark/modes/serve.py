"""Serving traffic: a closed loop of one client, which sends a seeded
coefficient field to the program's predictor, waits for the answer and
sends the next.

The end-to-end metrics are the requests answered per second of the
window, which ends with the last answer taken after ``seconds``, and
the 90th percentile of the requests' latencies (each the wall time of
its call; one client never queues). Once the window has closed, a
seeded sample of the answered requests is worked out again by the plain
reference and compared.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import numpy as np
import torch

from .. import compare, fields, harness, weights
from ..trace import Spans, Tracer


class Session:
    def __init__(self, cell, seed: int, device, fault=None):
        cfg, traffic = cell.cfg, cell.traffic
        self.cell, self.device, self.fault = cell, device, fault
        s_fields, s_weights, s_order, self.s_sample = fields.seeds(seed, 4)
        self.fields = fields.darcy_fields(np.random.default_rng(s_fields),
                                          traffic["fields"],
                                          cfg["source_res"])
        r = cfg["downsample"]
        self.requests = self.fields["coeff"][:, ::r, ::r]
        rng = np.random.default_rng(s_order)
        self.pick = lambda: int(rng.integers(traffic["fields"]))
        self.w0 = weights.draw(cell.system().weight_specs(cfg), s_weights,
                               device)
        self.p0 = {k: v.detach().cpu().clone() for k, v in self.w0.items()}
        self.served = []      # field index of each request, in order

    def start(self):
        system = self.cell.system()
        self.build_s = (harness.build_kernels(system.kernel_sources(
            self.cell.cfg)) if self.device.type == "cuda" else 0.0)
        self.system = system.Serving(self.cell.cfg, self.fields,
                                     self.cell.traffic, self.w0, self.device)

    def request(self):
        f = self.pick()
        self.served.append(f)
        out = self.system.predict(self.requests[f])
        if self.fault == "answer_altered":
            out = out.copy()
            out[0] += 0.05 * float(np.abs(out).max())
        return out

    def free(self):
        self.system = self.w0 = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, answers: dict) -> list:
        """The compared requests: a seeded quarter of the window's."""
        ks = sorted(answers)
        n = max(1, math.ceil(len(ks) * self.cell.traffic["compared_share"]))
        rng = np.random.default_rng(self.s_sample)
        return sorted(int(k) for k in rng.choice(ks, size=n, replace=False))

    def reference(self, ks: list, rounding: str = "float32") -> dict:
        ref = self.cell.reference().Server(
            self.cell.cfg, self.p0, self.fields,
            self.cell.traffic["splitter_seed"], self.device, rounding)
        return {k: ref.predict(k, self.requests[self.served[k]])
                for k in ks}


def percentile(values: list, q: float) -> float:
    """The ``q`` quantile of ``values`` by the nearest rank: the
    smallest value that at least a share ``q`` of them do not exceed."""
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q * len(ranked)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None, log=print) -> dict:
    ses = Session(cell, seed, device, fault)
    ses.start()
    for _ in range(cell.traffic["warmup_requests"]):
        ses.request()
    setup_s = time.perf_counter() - t_start
    log(f"build_s {ses.build_s:.3f} (kernels and graph builder, where "
        f"missing)")
    log(f"setup_s {setup_s:.3f}")

    harness.zero_counters()
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    first = len(ses.served)
    answers, failed, spans = {}, 0, Spans()
    with Tracer(sync, spans) if trace else contextlib.nullcontext() as tracer:
        t0 = time.perf_counter()
        while True:
            k = len(ses.served)
            try:
                answers[k] = spans.call("request", ses.request)
            except RuntimeError as err:
                failed += 1
                log(f"request {k} failed: {err}")
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    n = len(ses.served) - first
    counters = harness.read_counters()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    latency = spans.seconds("request")
    p90_ms = 1e3 * percentile(latency, 0.9)
    log(f"requests in window {n} ({failed} failed), window_s "
        f"{window_s:.6f}; latency p50 {1e3 * statistics.median(latency):.3f}"
        f" ms, p90 {p90_ms:.3f} ms, max {1e3 * max(latency):.3f} ms")
    if tracer:
        log(f"profiler stop and trace read {tracer.read_s:.3f} s")
    log(f"launches a request {({k: v / n for k, v in counters.items() if v})}")
    log(f"memory_peak_bytes {peak} ({peak / 2 ** 30:.3f} GiB)")
    ks = ses.sample(answers) if answers else []
    flops = None
    if trace:
        counter = cell.reference().Server(
            cell.cfg, ses.p0, ses.fields, cell.traffic["splitter_seed"],
            "cpu")
        flops = {"bf16": 0.0, "f32": 0.0}
        for k in range(first, first + n):
            c = ses.system.forward_flops(cell.cfg, counter.edge_counts(k))
            for key in flops:
                flops[key] += c[key]
    ctx = harness.Context(
        trace=tracer.trace if tracer else None,
        window_s=window_s, work=n, spans={"request": latency},
        flops=flops, shapes={}, counters=counters)
    ses.free()
    t_ref = time.perf_counter()
    ref = ses.reference(ks)
    log(f"reference_s {time.perf_counter() - t_ref:.3f} over {len(ks)} "
        f"requests {ks}")
    missing = [k for k in range(first, first + n) if k not in answers]
    gap = max([compare.field_gap(answers.get(k), ref[k]) for k in ks]
              + [math.inf] * bool(missing or not ks))
    return dict(setup_s=setup_s, window_s=window_s, attempted=n,
                failed=failed, memory_peak=peak, context=ctx,
                e2e={"setup_s": setup_s, "requests_per_s": (n - failed)
                     / window_s, "request_ms_p90": p90_ms},
                numbers={"field_gap": gap})
