"""Every cell shrunk to a size the CPU runs in seconds, through the port's
plain versions (``device="cpu"``): the tests' way into the loop drivers."""

import time

from benchmark import harness

RX = {"streams": 4, "chunks_per_stream": 6, "warm_chunks": 3, "lead_in": [0, 3000]}
CELLS = {
    "qpsk64.long": RX,
    "bpskrep32k.decode": {"file_bytes": 2000, "pool": 2},
    "bpskrep32k.oncard": {"file_bytes": 2000, "pool": 2},
    "narrow1k.decode": {"pool": 2},
}


def context(cell: str, seed: int, trace: bool = False, extra: dict | None = None) -> harness.Context:
    wl, cfg = harness.load_cell(cell)
    return harness.Context(wl, cfg, seed, 0.05, trace, "cpu", time.perf_counter(), {**CELLS[cell], **(extra or {})})


def run(cell: str, seed: int, trace: bool = False, extra: dict | None = None) -> harness.Outcome:
    ctx = context(cell, seed, trace, extra)
    return harness.load_driver(ctx.workload["driver"]).run(ctx)
