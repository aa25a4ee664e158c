"""The port's CLI against the JAX package's: each subcommand through both
packages' ``main([...])`` on the same files (the port with
``--torch-device cpu``), in a directory of its own so that the printed
paths read alike. Encoded WAVs agree within 1 LSB (the TX tolerance is
3e-5, so a sample may round to the neighbouring int16 code); decoded and
received files are byte-identical and the printed lines equal; diagnose's
JSON is equal with floats within 1e-4."""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from audio_modem_tpu import cli as jcli
from audio_modem_tpu_torch import cli
from audio_modem_tpu_torch.utils.wav import read_wav, write_wav

torch.set_num_threads(2)

SMALL = np.random.default_rng(3).bytes(900)  # one legacy frame
BIG = np.random.default_rng(4).bytes(32 * 1024 + 3000)  # chunked: metadata + 18 chunks


def _run(main, argv, where, capsys, monkeypatch) -> tuple[int, list[str]]:
    monkeypatch.chdir(where)
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


@pytest.fixture
def dirs(tmp_path):
    """Two working directories, the port's and the JAX package's, each with
    small.bin and big.bin."""
    out = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        (d / "small.bin").write_bytes(SMALL)
        (d / "big.bin").write_bytes(BIG)
        out[name] = d
    return out


def _both(argv, dirs, capsys, monkeypatch, same_lines=True):
    rc, lines = _run(cli.main, ["--torch-device", "cpu", *argv], dirs["port"], capsys, monkeypatch)
    rc_ref, ref_lines = _run(jcli.main, list(argv), dirs["jax"], capsys, monkeypatch)
    assert rc == rc_ref
    if same_lines:
        assert lines == ref_lines
    return rc, lines, ref_lines


def _same_wav(dirs, name: str) -> np.ndarray:
    a, ra = read_wav(str(dirs["port"] / name))
    b, rb = read_wav(str(dirs["jax"] / name))
    assert ra == rb == 44100 and a.shape == b.shape
    codes = lambda x: np.round(x.astype(np.float64) * 32768.0)  # noqa: E731 - read_wav divides by 32768
    assert np.abs(codes(a) - codes(b)).max() <= 1
    return a


@pytest.mark.parametrize("src, mode", [("small.bin", "QPSK"), ("big.bin", "QPSK"), ("small.bin", "BPSK-ACOUSTIC")])
def test_encode_then_decode_or_receive(dirs, capsys, monkeypatch, src, mode):
    _both(["encode", src, "s.wav", "--mode", mode], dirs, capsys, monkeypatch)
    _same_wav(dirs, "s.wav")
    cmd = "decode" if src == "small.bin" else "receive"
    rc, lines, _ = _both([cmd, "s.wav", "-o", "out.bin", "--mode", mode], dirs, capsys, monkeypatch)
    assert rc == 0 and len(lines) == 1
    for d in dirs.values():
        assert (d / "out.bin").read_bytes() == (d / src).read_bytes()


def test_decode_trim_max_duration_and_corrupted(dirs, capsys, monkeypatch):
    """The frame behind 1 s of junk: --trim-* cut it out, an empty range
    fails, --max-duration caps the read, and a frame whose payload is hit
    is written with a .corrupted suffix — alike in both packages."""
    _both(["encode", "small.bin", "s.wav", "--mode", "QPSK"], dirs, capsys, monkeypatch)
    sig, _ = read_wav(str(dirs["jax"] / "s.wav"))
    junk = (np.random.default_rng(5).standard_normal(44100) * 0.4).astype(np.float32)
    mid = sig.copy()
    p0 = 13230 + 3 * 576 + 10 * 576  # ten symbols into the data
    mid[p0 : p0 + 200] = 0.0
    for d in dirs.values():
        write_wav(str(d / "rec.wav"), np.concatenate([junk, sig, junk]))
        write_wav(str(d / "hit.wav"), mid)
    end = str(1.0 + len(sig) / 44100)
    cases = [
        (["decode", "rec.wav", "-o", "t.bin", "--trim-start", "1.0", "--trim-end", end], 0),
        (["decode", "rec.wav", "--trim-start", "5", "--trim-end", "4"], 1),
        (["decode", "s.wav", "-o", "c.bin", "--max-duration", str(len(sig) / 44100 + 0.1)], 0),
        (["decode", "s.wav", "--max-duration", "0.05"], 1),
        (["decode", "hit.wav", "-o", "h.bin"], 0),
    ]
    for argv, want in cases:
        rc, _, _ = _both(argv + ["--mode", "QPSK"], dirs, capsys, monkeypatch)
        assert rc == want, argv
    for d in dirs.values():
        assert (d / "t.bin").read_bytes() == SMALL and (d / "c.bin").read_bytes() == SMALL
        assert not (d / "h.bin").exists()
        assert (d / "h.bin.corrupted").read_bytes() == (dirs["jax"] / "h.bin.corrupted").read_bytes()


def _same_json(lines, ref_lines) -> dict:
    ours, ref = json.loads(lines[-1]), json.loads(ref_lines[-1])

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, float) or isinstance(b, float):
            assert abs(a - b) <= 1e-4 + 1e-9, (a, b)
        else:
            assert a == b

    same(ours, ref)
    return ours


def test_testsignal_diagnose_sweep_info(dirs, capsys, monkeypatch):
    _both(["testsignal", "ts.wav", "--mode", "QPSK"], dirs, capsys, monkeypatch)
    _same_wav(dirs, "ts.wav")
    _, lines, ref_lines = _both(["diagnose", "ts.wav", "--mode", "QPSK"], dirs, capsys, monkeypatch,
                                same_lines=False)
    rep = _same_json(lines, ref_lines)
    assert rep["detected"] and rep["quality"] == "excellent" and rep["ber"] == 0.0
    _, lines, ref_lines = _both(["diagnose", "--live", "--mode", "QPSK", "--channel", "gain=0.5,echo=50:0.3"],
                                dirs, capsys, monkeypatch, same_lines=False)
    rep = _same_json(lines, ref_lines)
    assert rep["detected"] and rep["samples_recorded"] > 0
    _both(["sweep", "sw.wav"], dirs, capsys, monkeypatch)
    assert (dirs["port"] / "sw.wav").read_bytes() == (dirs["jax"] / "sw.wav").read_bytes()
    _, lines, _ = _both(["info"], dirs, capsys, monkeypatch)
    assert len(lines) == 7 and "BPSK-NARROW" in lines[5]


@pytest.mark.parametrize("pcm", ["f32", "s16"])
def test_play_to_a_file_then_listen(dirs, capsys, monkeypatch, pcm):
    """play --no-pace into a file, then listen on it: the port's PCM is the
    JAX package's within the TX tolerance (1 LSB in s16) and both listeners
    write the file."""
    _both(["play", "big.bin", "sig.pcm", "--no-pace", "--pcm", pcm], dirs, capsys, monkeypatch)
    dtype = np.float32 if pcm == "f32" else np.int16
    a = np.fromfile(dirs["port"] / "sig.pcm", dtype).astype(np.float64)
    b = np.fromfile(dirs["jax"] / "sig.pcm", dtype).astype(np.float64)
    assert a.shape == b.shape and np.abs(a - b).max() <= (3e-5 if pcm == "f32" else 1)
    shutil.copy(dirs["jax"] / "sig.pcm", dirs["port"] / "jax.pcm")
    for src in ("sig.pcm", "jax.pcm"):
        monkeypatch.chdir(dirs["port"])
        assert cli.main(["--torch-device", "cpu", "listen", src, "-o", "l.bin", "--pcm", pcm]) == 0
        assert (dirs["port"] / "l.bin").read_bytes() == BIG
        os.remove(dirs["port"] / "l.bin")


def test_listen_from_stdin_and_play_to_stdout(dirs, monkeypatch):
    monkeypatch.chdir(dirs["port"])
    out = io.TextIOWrapper(io.BytesIO())
    monkeypatch.setattr(sys, "stdout", out)
    assert cli.main(["--torch-device", "cpu", "play", "small.bin", "--no-pace"]) == 0
    out.flush()
    pcm = out.buffer.getvalue()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(pcm)))
    assert cli.main(["--torch-device", "cpu", "listen", "-", "-o", "in.bin"]) == 0
    assert (dirs["port"] / "in.bin").read_bytes() == SMALL


def test_without_a_card_main_raises(dirs, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    monkeypatch.chdir(dirs["port"])
    for argv in (["encode", "small.bin", "x.wav"], ["info"], ["--torch-device", "cuda", "sweep", "x.wav"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not (dirs["port"] / "x.wav").exists()


def test_bench_runs_the_ports_bench(monkeypatch):
    """``bench`` calls ``audio_modem_tpu_torch.bench.main`` on the device
    given by ``--torch-device``, returns its exit code, and never imports
    the root bench.py (blocked here, so an import would raise)."""
    from audio_modem_tpu_torch import bench

    calls = []

    def fake_main(device):
        calls.append(device)
        return 1

    monkeypatch.setitem(sys.modules, "bench", None)
    monkeypatch.setattr(bench, "main", fake_main)
    assert cli.main(["--torch-device", "cpu", "bench"]) == 1
    assert calls == [torch.device("cpu")]
