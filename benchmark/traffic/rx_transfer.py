"""The multi-stream receiver's loop: closed-loop transfers through
``BatchReceiver``, one caller.

A transfer is a fresh receiver fed every block of one chunked file a
stream, then flushed; it ends when the receiver's results (the assembled
files) are in hand. Transfers follow each other until the window has
lasted ``--seconds``; the last one runs to its end.

Traffic, made from the seed on the card at set-up by the benchmark's own
transmitter (``reference.oracle``): each stream carries its own seeded
file, behind a seeded lead-in of noise, as the metadata frame and one data
frame a chunk (the wire layout of app.js:201-303), with seeded extra
silence before every data frame where the mix asks for jitter, under AWGN.
Blocks go to the receiver as views of that tensor on the card, or as
pageable host arrays (``feed: host``).

Compared after the window: every file of every transfer byte for byte
against the seeded payload, and on a seeded sample of kernel A's and kernel
C's calls in the window the frame start, the refined metric and (kernel A)
the channel estimate against the reference's on the same samples.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from audio_modem_tpu_torch.configs import MODES as PORT_MODES
from audio_modem_tpu_torch.parallel import batch, multi_receiver
from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver
from benchmark import capture, trace
from benchmark.harness import Context, Outcome, Readings
from benchmark.reference import oracle, roofline
from benchmark.reference.profiles import MODES, Mode

KEEP = 3  # kernel calls a run keeps for the comparison, per kernel
# the kernel entries, at the names the receiver's rounds look them up by
TARGETS = {"decode_fused": (batch, "decode_fused"), "decode_predicted": (multi_receiver, "decode_predicted")}


@dataclasses.dataclass
class Streams:
    sig: torch.Tensor  # [n, T] float32, the received audio of every stream
    files: np.ndarray  # [n, n_chunks * chunk] uint8, the payload of each stream
    end_block: np.ndarray  # [n, n_chunks]: block that holds each data frame's last sample
    block: int
    host: np.ndarray | None = None  # [n_blocks, n, block] float32 for a host feed

    @property
    def n_blocks(self) -> int:
        return self.sig.shape[1] // self.block


def make_streams(mode: Mode, n: int, block: int, n_chunks: int, lead: list, jitter: list, snr_db: float,
                 seed: int, device, host: bool = False) -> Streams:
    """The seeded traffic of one transfer (see the module docstring). Sizes
    (lead-ins, gaps) come from a NumPy generator on the seed; payloads and
    noise from a torch.Generator on the device."""
    p = mode.profile
    chunk = mode.chunk_size
    rng = np.random.default_rng(seed)
    lead_in = rng.integers(lead[0], lead[1] + 1, size=n)
    gaps = rng.integers(jitter[0], jitter[1] + 1, size=(n, n_chunks))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    files = torch.randint(0, 256, (n, n_chunks * chunk), generator=gen, device=device, dtype=torch.uint8)
    seqs = torch.arange(n_chunks, device=device).repeat(n)
    payloads = oracle.data_chunk_payloads(files.reshape(n * n_chunks, chunk), seqs)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    flen = oracle.frame_len(payloads.shape[1], mode, pre, post)
    n_sym = (flen - pre - post) // p.symbol_len
    metas = [oracle.frames(torch.tensor(list(oracle.metadata_payload(n_chunks, n_chunks * chunk, chunk, f"s{i}.bin")),
                                        dtype=torch.uint8, device=device)[None],
                           mode, p.silence_pre_chunk(True), post)[0] for i in range(n)]
    meta_len = np.array([m.shape[0] for m in metas])
    starts = (lead_in + meta_len)[:, None] + np.cumsum(gaps + flen, axis=1) - flen
    ends = starts + flen
    t = (-(-int(ends.max()) // block) + 1) * block  # one block of noise after the longest stream
    sig = torch.zeros((n, t), dtype=torch.float32, device=device)
    for i in range(n):
        sig[i, lead_in[i] : lead_in[i] + meta_len[i]] = metas[i]
        fr = oracle.frames(payloads[i * n_chunks : (i + 1) * n_chunks], mode, pre, post)
        if not gaps[i].any():
            sig[i, starts[i, 0] : ends[i, -1]] = fr.reshape(-1)
        else:
            idx = torch.as_tensor(starts[i], device=device)[:, None] + torch.arange(flen, device=device)
            sig[i, idx.reshape(-1)] = fr.reshape(-1)
        power = float((sig[i, : ends[i, -1]].to(torch.float64) ** 2).mean())
        sig[i] += torch.randn(t, generator=gen, device=device) * (power / 10 ** (snr_db / 10)) ** 0.5
    st = Streams(sig, files.cpu().numpy(), (starts + pre + n_sym * p.symbol_len - 1) // block, block)
    if host:
        st.host = sig.reshape(n, -1, block).permute(1, 0, 2).contiguous().cpu().numpy()
    return st


def streams_for(ctx: Context, seed: int, n_chunks: int) -> Streams:
    return make_streams(MODES[ctx.param("mode")], ctx.param("streams"), ctx.param("block"), n_chunks,
                        ctx.param("lead_in"), ctx.param("jitter"), ctx.param("snr_db"), seed, ctx.device,
                        host=ctx.param("feed") == "host")


class ChunkPoll:
    """Which data chunks each stream's assembler holds after a return of
    ``process_blocks`` or ``flush``: streams whose count moved are walked
    from their next expected chunk; one whose chunks came out of order is
    compared with its bitmap."""

    def __init__(self, rx: BatchReceiver, n_chunks: int):
        self.rx, self.n_chunks = rx, n_chunks
        n = rx.n
        self.count = np.zeros(n, dtype=np.int64)
        self.next = np.zeros(n, dtype=np.int64)
        self.seen = np.zeros((n, n_chunks), dtype=bool)
        self.got: list[tuple[int, int, int]] = []  # (stream, chunk, return index)

    def poll(self, ret: int) -> None:
        asms = [s.assembler for s in self.rx.streams]
        count = np.fromiter((a.received_count for a in asms), dtype=np.int64, count=len(asms))
        for i in np.flatnonzero(count != self.count):
            a, want = asms[i], int(count[i] - self.count[i])
            q, found = int(self.next[i]), 0
            while found < want and q < self.n_chunks and a.is_received(q):
                if not self.seen[i, q]:
                    self.seen[i, q] = True
                    self.got.append((i, q, ret))
                    found += 1
                q += 1
            self.next[i] = q
            if found < want:
                bm = a.bitmap()[: self.n_chunks]
                for q in np.flatnonzero(bm & ~self.seen[i]):
                    self.seen[i, q] = True
                    self.got.append((i, int(q), ret))
        self.count = count


def transfer(ctx: Context, st: Streams, poll: bool) -> dict:
    """One transfer; with ``poll`` the delay of every data chunk from the
    hand-over of the block that completes its frame to the return after
    which its stream's assembler holds it (host clock, ms)."""
    mode = PORT_MODES[ctx.param("mode")]
    rx = BatchReceiver(mode, ctx.param("streams"), device=ctx.device, **ctx.param("receiver"))
    n_chunks = st.end_block.shape[1]
    poller = ChunkPoll(rx, n_chunks) if poll else None
    t_in, t_ret = np.zeros(st.n_blocks), []
    b = st.block
    t0 = time.perf_counter()
    for j in range(st.n_blocks):
        t_in[j] = time.perf_counter()
        rx.process_blocks(st.host[j] if st.host is not None else st.sig[:, j * b : (j + 1) * b])
        if poller:
            t_ret.append(time.perf_counter())
            poller.poll(len(t_ret) - 1)
    rx.flush()
    if poller:
        t_ret.append(time.perf_counter())
        poller.poll(len(t_ret) - 1)
    files = [r["data"] for r in rx.results()]
    t1 = time.perf_counter()
    out = {"t0": t0, "t1": t1, "files": files, "stages": rx.timer.report(),
           "chunks": sum(s.assembler.received_count for s in rx.streams), "latencies_ms": []}
    if poller and poller.got:
        got = np.asarray(poller.got)
        done = np.asarray(t_ret)[got[:, 2]]
        out["latencies_ms"] = ((done - t_in[st.end_block[got[:, 0], got[:, 1]]]) * 1e3).tolist()
    rx.cleanup()
    return out


# ---------- the comparison ----------


def _gaps(start_s, start_r, fine_s, fine_r, both) -> tuple[float, float]:
    if not bool(both.any()):
        return 0.0, 0.0
    return (float((start_s.to(torch.int64) - start_r.to(torch.int64))[both].abs().max()),
            float((fine_s.to(torch.float64) - fine_r)[both].abs().max()))


def compare_a(kept: list, mode: Mode, subject=None) -> dict:
    """Kernel A's kept calls against the reference on their own windows:
    rows detected on one side only; over rows both detect, the widest start
    gap (samples), fine-metric gap, and channel-estimate gap as a share of
    the row's largest reference bin. ``subject`` None judges the program's
    outputs; a ``Precision`` judges the reference computed in it."""
    p = mode.profile
    res = {"detect_mismatch": 0, "start_gap": 0.0, "fine_gap": 0.0, "ce_gap": 0.0}
    for args, out in kept:
        x, nv, mp = args["signals"], args["n_valid"], args["min_pos"]
        ref = oracle.receive(x, nv, mp, p)
        if subject is None:
            s = {"start": out["start"], "fine": out["fine_metric"], "detected": out["detected"],
                 "ch": torch.complex(out["ch_re"].to(torch.float64), out["ch_im"].to(torch.float64))}
        else:
            s = oracle.receive(x, nv, mp, p, subject)
        res["detect_mismatch"] += int((s["detected"] != ref["detected"]).sum())
        both = s["detected"] & ref["detected"]
        sg, fg = _gaps(s["start"], ref["start"], s["fine"], ref["fine"], both)
        res["start_gap"], res["fine_gap"] = max(res["start_gap"], sg), max(res["fine_gap"], fg)
        if bool(both.any()):
            rel = (s["ch"] - ref["ch"]).abs().amax(1) / ref["ch"].abs().amax(1).clamp(min=1e-30)
            res["ce_gap"] = max(res["ce_gap"], float(rel[both].max()))
    return res


def compare_c(kept: list, mode: Mode, subject=None) -> dict:
    """Kernel C's kept calls: each predicted slot that the subject counts as
    detected is refined by the reference around the subject's previous
    start plus the cadence, as C's chain does, on the same window; the
    widest start and fine-metric gaps, and slots the reference finds no
    preamble at."""
    p = mode.profile
    res = {"detect_mismatch": 0, "start_gap": 0.0, "fine_gap": 0.0}
    for args, out in kept:
        w, nv = args["windows"], args["n_valid"]
        rows = torch.arange(w.shape[0], device=w.device)
        cad = int(args["cadence"])
        n_pred = out["start"].shape[1]
        if subject is None:
            s_start, s_fine, s_det = out["start"], out["fine_metric"], out["detected"]
        else:
            sig_s = oracle.preprocess(w, nv, subject)
            prev, ok, cols = args["start0"].to(torch.int64), args["ok0"], []
            for _ in range(n_pred):
                st, fi = oracle.refine(sig_s, rows, (prev + cad).clamp(0, w.shape[1] - 1), p, nv, subject)
                ok = ok & (fi >= 0.1)
                cols.append((st, fi, ok))
                prev = st
            s_start, s_fine, s_det = (torch.stack(c, 1) for c in zip(*cols))
        sig = oracle.preprocess(w, nv)
        for j in range(n_pred):
            prev = args["start0"] if j == 0 else s_start[:, j - 1]
            st, fi = oracle.refine(sig, rows, (prev.to(torch.int64) + cad).clamp(0, w.shape[1] - 1), p, nv)
            det = s_det[:, j]
            res["detect_mismatch"] += int((det & (fi < 0.1)).sum())
            both = det & (fi >= 0.1)
            sg, fg = _gaps(s_start[:, j], st, s_fine[:, j], fi, both)
            res["start_gap"], res["fine_gap"] = max(res["start_gap"], sg), max(res["fine_gap"], fg)
    return res


def bad_chunks(files: list[bytes], truth: np.ndarray, chunk: int) -> int:
    """Chunks of a transfer's files that are missing or differ from the payload."""
    n_chunks = truth.shape[1] // chunk
    bad = 0
    for data, exp in zip(files, truth):
        got = np.frombuffer(data, dtype=np.uint8)
        if got.shape != exp.shape:
            bad += n_chunks
            continue
        bad += int((got.reshape(n_chunks, chunk) != exp.reshape(n_chunks, chunk)).any(1).sum())
    return bad


def run(ctx: Context) -> Outcome:
    mode = MODES[ctx.param("mode")]
    n_chunks = ctx.param("chunks_per_stream")
    warm = streams_for(ctx, ctx.seed + 1, ctx.param("warm_chunks"))
    transfer(ctx, warm, poll=ctx.trace)  # builds and loads every kernel, fills the allocators
    del warm
    st = streams_for(ctx, ctx.seed, n_chunks)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start

    ingest = {"s": 0.0, "calls": 0}
    inner_write = multi_receiver.DeviceRing.write
    if ctx.trace:
        def timed_write(self, blocks):
            t = time.perf_counter()
            try:
                return inner_write(self, blocks)
            finally:
                ingest["s"] += time.perf_counter() - t
                ingest["calls"] += 1
        multi_receiver.DeviceRing.write = timed_write
    transfers = []
    try:
        with capture.Taps(ctx.seed, KEEP, ctx.trace, TARGETS) as taps, \
                trace.DeviceTrace(ctx.trace, ctx.device) as tr:
            t_w0 = time.perf_counter()
            while True:
                transfers.append(transfer(ctx, st, poll=ctx.trace))
                if time.perf_counter() - t_w0 >= ctx.seconds:
                    break
            t_w1 = time.perf_counter()
    finally:
        multi_receiver.DeviceRing.write = inner_write
    peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0

    chunk = mode.chunk_size
    bad = [bad_chunks(t["files"], st.files, chunk) for t in transfers]
    per = st.files.shape[0] * n_chunks
    samples = st.sig.shape[0] * st.n_blocks * st.block
    good = sum(1 for b in bad if b == 0)
    kept_a, kept_c = taps.by_name["decode_fused"].kept, taps.by_name["decode_predicted"].kept

    def kernel_gaps(subject=None) -> dict:
        a, c = compare_a(kept_a, mode, subject), compare_c(kept_c, mode, subject)
        return {"detect_mismatch": a["detect_mismatch"] + c["detect_mismatch"],
                "start_gap": max(a["start_gap"], c["start_gap"]), "fine_gap": max(a["fine_gap"], c["fine_gap"]),
                "ce_gap": a["ce_gap"]}

    limits = ctx.config["limits"]
    found = {"bad_chunks": sum(bad), **kernel_gaps()}
    stages: dict = {}
    for t in transfers:
        for k, v in t["stages"].items():
            acc = stages.setdefault(k, {"seconds": 0.0, "calls": 0})
            acc["seconds"] += v["seconds"]
            acc["calls"] += v["calls"]
    readings = Readings(
        mode=mode, stages=stages,
        counts={"transfers": len(transfers), "streams": st.sig.shape[0], "chunks": sum(t["chunks"] for t in transfers),
                "blocks": len(transfers) * st.n_blocks, "ingest_s": ingest["s"], "ingest_calls": ingest["calls"]},
        shapes=taps.shapes(), latencies_ms=[x for t in transfers for x in t["latencies_ms"]],
        events=tr.events, window_s=tr.window_s,
        peaks=roofline.PEAKS.get(torch.cuda.get_device_name(0)) if ctx.device != "cpu" else None)
    return Outcome(
        metrics={"setup_s": setup_s, "rx_msps": good * samples / (t_w1 - t_w0) / 1e6},
        checks={k: (v, limits[k]) for k, v in found.items() if k in limits},
        attempted=len(transfers) * per, failed=sum(bad), readings=readings, memory_peak_bytes=peak,
        breakdown=trace.breakdown(tr.events) if tr.events is not None else None, control=kernel_gaps)
