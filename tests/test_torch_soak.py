"""The port's config-5 drivers on the CPU at a tiny depth: the soak's
device-synthesized signal against ``api.encode_chunked``, the soak (plain
and over a virtual mesh), the lossy-channel ARQ soak, the consume
microbench and the demo."""

import json

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import api
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.examples import demo
from audio_modem_tpu_torch.parallel.mesh import make_mesh
from audio_modem_tpu_torch.tools import bench_consume, soak, soak_lossy

torch.set_num_threads(2)


@pytest.mark.parametrize("fec", [False, True], ids=["plain", "fec"])
def test_soak_signal_is_the_chunked_wire_layout(fec):
    """One batched synthesis of the metadata frame and every data frame
    equals api.encode_chunked of the same bytes within 3e-5, sample for
    sample."""
    mode = MODES["QPSK"]
    data = np.random.default_rng(5).bytes(mode.chunk_size * 5)
    got = soak.synth_signal(data, "s3.bin", mode, torch.device("cpu"), fec=fec)
    want = torch.cat(list(api.encode_chunked(data, mode, "s3.bin", fec=fec, batch=2, device="cpu")))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 3e-5


@pytest.mark.parametrize("mesh_devices", [None, ["cpu"] * 4], ids=["unsharded", "mesh4"])
def test_tiny_soak_is_exact(mesh_devices, tmp_path):
    mesh = make_mesh(devices=mesh_devices) if mesh_devices else None
    record = soak.run_soak(0.0062, 8, device="cpu", mesh=mesh)
    assert soak.passed(record)
    assert record["chunks_received"] == record["chunks_expected"] == 8 * 3
    assert record["device"] == "cpu" and record["config"]["mesh"] == (["cpu"] * 4 if mesh else None)
    assert record["stage_breakdown"]["multi_consume"]["calls"] >= 1
    soak.write_record(record, tmp_path / "soak.json")
    text = (tmp_path / "soak.json").read_text()
    assert text.startswith("{") and text.endswith("}\n") and json.loads(text)["chunks_received"] == 8 * 3


def test_soak_main_writes_its_record(tmp_path):
    out = tmp_path / "s.json"
    assert soak.main(["0.0042", "8", "--torch-device", "cpu", "--mesh", "cpu,cpu", "--out", str(out)]) == 0
    assert '"payload_bitexact": true' in out.read_text()


def test_tiny_lossy_soak_completes_every_stream():
    record = soak_lossy.run_lossy(0.0062, 8, device="cpu")
    assert record["pass"] and record["total_streams"] == 16
    for s in record["sessions"]:
        assert s["incomplete_streams"] == [] and s["payload_bitexact"]
        assert s["missing_after_round1"] > 0 and s["arq_rounds"] >= 2  # the dropouts cost chunks, ARQ brings them back
        # one entry a round that arq_rounds counts, the first transmission's included
        assert len(s["resend_counts_per_round"]) == len(s["crc_errors_per_round"]) == s["arq_rounds"]
        assert s["resend_counts_per_round"][0] == 0 and all(c > 0 for c in s["resend_counts_per_round"][1:])
        assert sum(s["crc_errors_per_round"]) == s["crc_errors"] and min(s["crc_errors_per_round"]) >= 0


def test_bench_consume_stores_every_chunk():
    result = bench_consume.run(4, 32)
    assert result["stored"] == result["expected"] == 4 * 32
    assert len(result["us_per_chunk"]) == 4


def test_demo_payload_matches(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert demo.main(["--torch-device", "cpu"])
    assert "payload match: True" in capsys.readouterr().out
    assert (tmp_path / "demo_out" / "received.bin").read_bytes() == (tmp_path / "demo_out" / "original.bin").read_bytes()
