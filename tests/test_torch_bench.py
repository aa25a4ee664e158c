"""The port's bench (audio_modem_tpu_torch/bench.py) on the CPU at small
sizes: every stage of the root bench.py runs and lands in the details
file, the last stdout line is the four-key headline, a stage that raises is
listed as failed and makes ``main`` return 1; its headline round and
per-mode inputs agree with the JAX package's; and the roofline module gives
the bounds chip_smoke.py prints, which keeps no copy of it."""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import batch as jbatch
from audio_modem_tpu.parallel import multi_receiver as jmr
from audio_modem_tpu_torch import MODES, bench, framing, roofline
from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.parallel import multi_receiver as mr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# a few streams and frames, payloads cut to a few symbols; bench.py's sizes otherwise
TINY = dict(n_streams=4, K=2, iters=1, unique=2, batches=(4, 8), chunk=64, long_bytes=(16, 64),
            receiver_chunks=(1, 2))
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
# every details key of every stage of the root bench, *_xla_msps renamed *_plain_msps
STAGE_KEYS = {
    "spot-check": ["headline_1frame_msps"],
    "headline": ["headline_frames_per_dispatch", "headline_samples_per_dispatch", "headline_percall_ms",
                 "frames_per_sec", "realtime_streams_per_chip", "predicted_kernel_msps"],
    "batch512": ["batch512_full_pipeline_msps", "batch512_realtime_streams"],
    "batch4096": ["batch4096_full_pipeline_msps", "batch4096_realtime_streams"],
    "dispatch_floor": ["dispatch_floor_ms", "local_dispatch_proxy_ms", "headline_dispatch_bound_msps",
                       "headline_floor_fraction", "headline_analysis"],
    "roofline": ["roofline"],
    "detect_latency": ["p50_detect_latency_ms", "p50_detect_latency_device_ms", "detect_latency_note"],
    "frame_demod": ["frame_demod_only_msps"],
    "encode": ["encode_modulate_msps"],
    "encode_frames": ["encode_frame_synth_msps", "encode_frames512_msps", "encode_frames4096_msps"],
    "long_frame": ["long_frame_kernel_msps", "long_frame_plain_msps", "long_frame_dispatch_msps"],
    "long_frame_standard": ["long_std_kernel_msps", "long_std_plain_msps", "long_std_dispatch_msps"],
    "batch_receiver": ["batch_receiver_msps", "batch_receiver_turbo_msps", "batch_receiver_device_msps",
                       "batch_receiver_realtime_streams", "batch_receiver_stage_breakdown",
                       "batch_receiver_nonfetch_msps", "h2d_bandwidth_mbps", "d2h_bandwidth_mbps",
                       "batch_receiver_d2h_bound_msps", "batch_receiver_analysis"],
    "modes": ["per_mode_msps"],
}
H100 = "NVIDIA H100 80GB HBM3"


def _last_json_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_run_on_cpu_at_tiny_sizes(tmp_path, monkeypatch, capsys):
    details_path = tmp_path / "bench.json"
    monkeypatch.setenv("AMT_BENCH_DETAILS", str(details_path))
    reset_launch_counts()
    assert bench.main("cpu", **TINY) == 0
    assert not any(launch_counts().values())  # plain versions
    headline = _last_json_line(capsys.readouterr().out)
    assert set(headline) == HEADLINE_KEYS
    assert headline["unit"] == "Msamples/s" and headline["value"] > 0
    assert headline["vs_baseline"] == pytest.approx(headline["value"] / 44.1, abs=1e-3)  # each rounded
    assert "on the CPU" in headline["metric"] and "chip" not in headline["metric"]
    written = json.loads(details_path.read_text())
    assert {k: written[k] for k in HEADLINE_KEYS} == headline
    d = written["details"]
    missing = [k for keys in STAGE_KEYS.values() for k in keys if k not in d]
    assert missing == []
    assert "failed_stages" not in d and "skipped_stages" not in d
    assert not [k for k in d if k.endswith("_xla_msps")]
    assert sorted(d["per_mode_msps"]) == sorted(bench.MODE_NAMES) and all(v > 0 for v in d["per_mode_msps"].values())
    assert d["device"]["name"] == "cpu" and d["device"]["torch"] == torch.__version__
    # off the card: no device figure, no roofline share
    assert d["p50_detect_latency_device_ms"] is None and d["h2d_bandwidth_mbps"] is None
    assert d["roofline"]["assumed_peaks"] is None
    assert set(d["roofline"]["kernels"]) == {"A (decode_fused) at batch4096", "B (decode_chunks_fused) at frame_demod",
                                             "C (decode_predicted) at the turbo round",
                                             "streaming demod (stream_demod) at long_frame"}
    for r in d["roofline"]["kernels"].values():
        assert r["pct_of_hbm"] is None and r["pct_of_fp32"] is None and r["bound_by"] is None
        assert r["bytes_per_sample"] > 0 and r["fp32_flops_per_sample"] > 0
    for text in (d["headline_analysis"], d["detect_latency_note"], d["batch_receiver_analysis"]):
        assert "tunnel" not in text and "relay" not in text and "TPU" not in text


def test_headline_round_matches_jax():
    """The headline's windows from the same payloads in both packages agree
    within 3e-5, and both packages' rounds give the same packed bytes."""
    n, k, chunk = 4, 3, 128
    mode, jmode = MODES["QPSK"], JMODES["QPSK"]
    p = mode.profile
    u8 = bench.turbo_payloads(np.random.default_rng(0), n, k, chunk)
    windows, cadence, n_sym = bench.turbo_windows(u8, mode, n, k, "cpu")
    frames = jframing._synth_frames_core(jnp.asarray(u8), jmode, n_sym, p.silence_pre_chunk(False),
                                         p.silence_post_chunk())
    jwin = np.zeros(tuple(windows.shape), np.float32)
    jwin[:, : k * cadence] = np.asarray(frames).reshape(n, k * cadence)
    assert np.abs(windows.numpy() - jwin).max() < 3e-5
    zeros, n_valid = np.zeros(n, np.int32), np.full(n, k * cadence, np.int32)
    out = mr._batch_window_decode_multi(windows, torch.from_numpy(zeros), torch.from_numpy(n_valid), mode, n_sym, k,
                                        cadence).numpy()
    ref = np.asarray(jmr._batch_window_decode_multi(jnp.asarray(jwin), jnp.asarray(zeros), jnp.asarray(n_valid), jmode,
                                                    n_sym, k, cadence))
    assert out.shape == ref.shape and np.array_equal(out, ref)
    det, _, full, seq = mr._classify_round(out, chunk)
    assert det.all() and full.all() and (seq == np.arange(k)[None, :]).all()


@pytest.mark.parametrize("name", bench.MODE_NAMES)
def test_per_mode_frames_decode_as_in_jax(name):
    """The per-mode stage's frames (its payload sizes) through both packages'
    batch_decode_signals: start and detected equal, bits equal on every
    symbol inside n_valid that carries signal. The others are the silence
    after the frame: a constant, whose data bins hold rounding residue."""
    mode = MODES[name]
    sym = mode.profile.symbol_len
    payload = bench.mode_payload(name)
    _, sig, nv, max_syms = bench.chunk_frame_signals(np.random.default_rng(1), mode, payload, 2, 3, "cpu")
    n_data = framing.num_symbols_for_payload(payload + 11, mode)
    out = {k: v.numpy() for k, v in batch.batch_decode_signals(sig, nv, mode, max_syms).items()}
    ref = jbatch.batch_decode_signals(jnp.asarray(sig.numpy()), jnp.asarray(nv.numpy()), JMODES[name], max_syms)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert out["detected"].all()
    assert np.array_equal(out["start"], ref["start"]) and np.array_equal(out["detected"], ref["detected"])
    bps_sym = out["bits"].shape[1] // max_syms
    for i, s in enumerate(out["start"]):
        n_in = (int(nv[i]) - (int(s) + 3 * sym)) // sym
        silent = sig[i, int(s) + (3 + n_data) * sym : int(s) + (3 + n_in) * sym]
        assert n_in >= n_data and bool((silent == silent[0]).all())
        nb = n_data * bps_sym
        assert np.array_equal(out["bits"][i, :nb], ref["bits"][i, :nb])


def test_mode_payloads_are_the_root_bench_sizes():
    lengths = {name: bench.chunk_frame_signals(np.random.default_rng(2), MODES[name], bench.mode_payload(name), 1, 1,
                                               "cpu")[0].shape[1] for name in bench.MODE_NAMES}
    assert [bench.mode_payload(n) for n in bench.MODE_NAMES] == [2048, 4096, 4096, 512, 128, 170]
    assert lengths["BPSK-NARROW"] == 127_503 and lengths["QPSK"] == 28_431


@pytest.mark.parametrize("case, want", [("A", 0.0708), ("B", 0.0023), ("stream", 0.0097)])
def test_work_models_give_the_recorded_bounds(case, want):
    """PERF.md's bounds: kernel A at [64, 914,688] (41 symbols), kernel B on
    64 x 41 QPSK symbols, the streaming demod on config 2's 12,361 symbols."""
    peaks = roofline.card_peaks(H100)
    work = {"A": lambda: roofline.work_decode_fused(MODES["QPSK"], 64, 914_688, 41),
            "B": lambda: roofline.work_chunks(MODES["QPSK"], 64, 44 * 576, 41),
            "stream": lambda: roofline.work_stream_demod(MODES["BPSK-REPEAT"], 1, 12_361)}[case]()
    ms, by = roofline.bound_ms(*work, peaks)
    assert abs(ms - want) < 1e-4 and by == "bytes"


def test_roofline_shares_need_the_cards_peaks():
    work = roofline.work_chunks(MODES["QPSK"], 64, 44 * 576, 41)
    known = roofline.share(work, 64 * 44 * 576, 1000.0, roofline.card_peaks(H100))
    assert known["bound_by"] == "bytes"
    assert known["pct_of_hbm"] == pytest.approx(100 * work[0] / (64 * 44 * 576) * 1e9 / 3.35e12, rel=1e-3)
    assert roofline.card_peaks("NVIDIA A100-SXM4-80GB") is None
    unknown = roofline.share(work, 64 * 44 * 576, 1000.0, roofline.card_peaks("NVIDIA A100-SXM4-80GB"))
    assert unknown["pct_of_hbm"] is None and unknown["pct_of_fp32"] is None and unknown["bound_by"] is None
    assert unknown["bytes_per_sample"] == known["bytes_per_sample"]


def test_chip_smoke_imports_the_roofline_and_keeps_no_copy():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    moved = {"bound_ms", "_fft_flops", "work_decode_fused", "work_chunks", "work_stream_demod", "card_peaks"}
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assigned = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)}
    assert not defined & moved
    assert not assigned & {"HBM_BYTES_PER_S", "FP32_FLOPS", "PEAKS"}
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                and n.module == "audio_modem_tpu_torch.roofline" for a in n.names}
    assert moved - {"_fft_flops"} <= imported


def _only_stages(monkeypatch, names):
    """Run the headline and only the stages ``names`` of the bench."""
    every = bench._Bench.stages
    monkeypatch.setattr(bench._Bench, "stages", lambda self: [s for s in every(self) if s[0] in names])


def test_a_stage_that_raises_is_failed_not_skipped(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("AMT_BENCH_DETAILS", str(tmp_path / "bench.json"))

    def boom(self):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench._Bench, "encode", boom)
    _only_stages(monkeypatch, ("encode", "encode_frames64"))
    assert bench.main("cpu", **TINY) == 1
    headline = _last_json_line(capsys.readouterr().out)
    assert set(headline) == HEADLINE_KEYS
    d = json.loads((tmp_path / "bench.json").read_text())["details"]
    assert d["failed_stages"] == [{"stage": "encode", "error": "RuntimeError: boom"}]
    assert "skipped_stages" not in d
    assert "encode_frame_synth_msps" in d and "batch512_full_pipeline_msps" not in d  # later stages still run


def test_budget_skips_are_listed(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("AMT_BENCH_DETAILS", str(tmp_path / "bench.json"))
    monkeypatch.setenv("AMT_BENCH_BUDGET_S", "100")  # under every stage's minimum but the roofline's
    _only_stages(monkeypatch, ("batch512", "roofline"))
    assert bench.main("cpu", **TINY) == 0
    assert set(_last_json_line(capsys.readouterr().out)) == HEADLINE_KEYS
    d = json.loads((tmp_path / "bench.json").read_text())["details"]
    assert d["skipped_stages"] == ["batch512"] and "failed_stages" not in d
    # only kernel C's rate, which the headline (never skipped) measures, has a row
    assert set(d["roofline"]["kernels"]) == {"C (decode_predicted) at the turbo round"}


def test_without_a_card_the_bench_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
