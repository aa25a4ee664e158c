"""The PyTorch port imports without JAX, without the JAX package, without
nvcc and without a GPU; its entry points default to the card; and CPU
tensors take the plain path without touching the kernel launch counters."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import MODES, api, arq, bench, channel, decoder, diag, entry, framing
from audio_modem_tpu_torch import kernels
from audio_modem_tpu_torch.kernels import _build, receive
from audio_modem_tpu_torch.parallel import multi_receiver, multihost
from audio_modem_tpu_torch.runtime import ingest
from audio_modem_tpu_torch.runtime import receiver as runtime_receiver

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "audio_modem_tpu_torch"

# every module of the port, and chip_smoke (whose main() imports the rest)
MODULES = sorted(
    ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for path in PACKAGE.rglob("*.py")
) + ["chip_smoke"]

ENTRY_POINTS = [
    (api, "encode_legacy"), (api, "encode_chunked"), (api, "encode"), (api, "decode"), (api, "decode_chunked"),
    (runtime_receiver, "StreamingReceiver"), (multi_receiver, "DeviceRing"), (multi_receiver, "BatchReceiver"),
    (channel, "apply_channel_np"),
    (decoder, "decode_raw"), (decoder, "decode_signal"), (decoder, "pad_aligned_frame"),
    (decoder, "decode_chunk_frame"),
    (framing, "synthesize_frames"), (framing, "build_data_chunk_frames"), (framing, "synthesize_frame"),
    (framing, "build_transmit_signal"), (framing, "build_metadata_frame"), (framing, "build_data_chunk_frame"),
    (ingest, "listen"), (ingest, "play"),
    (diag, "generate_test_signal"), (diag, "analyze_loopback"), (diag, "ber_vs_snr"),
    (diag, "repetition_ber_vs_snr"), (diag, "live_loopback_diagnosis"),
    (arq, "build_request_frame"), (arq, "run_arq_session"), (arq, "run_batch_arq_session"),
    (entry, "entry"), (entry, "dryrun_multihost"), (multihost, "run_dryrun"),
    (bench, "run"), (bench, "main"),
]


def _imports_of_jax_package(path: Path) -> list[str]:
    """The ``import audio_modem_tpu[...]`` and ``from audio_modem_tpu[...]``
    statements of one source file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else []
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n == "audio_modem_tpu" or n.startswith("audio_modem_tpu.")]
    return found


def test_imports_with_jax_blocked():
    """Every module imports with ``jax``, ``triton`` and ``audio_modem_tpu``
    blocked, and afterwards no module of either package is loaded."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'triton', 'audio_modem_tpu', 'bench'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert not [k for k in loaded if k == 'jax' or k.startswith('jax.')]\n"
        "assert not [k for k in loaded if k == 'audio_modem_tpu' or k.startswith('audio_modem_tpu.')]\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_imports_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for new in ("native.py", "runtime/ring.py", "runtime/assembler.py", "runtime/receiver.py",
                "utils/log.py", "utils/metrics.py", "utils/trace.py", "utils/wav.py", "channel.py",
                "parallel/multi_receiver.py", "runtime/ingest.py", "runtime/audiodev.py", "diag.py", "arq.py",
                "cli.py", "utils/plots.py", "parallel/mesh.py", "parallel/multihost.py", "entry.py",
                "tools/soak.py", "tools/soak_lossy.py", "tools/bench_consume.py", "examples/demo.py",
                "bench.py", "roofline.py"):
        assert PACKAGE / new in files and f"audio_modem_tpu_torch.{new[:-3].replace('/', '.')}" in MODULES
    assert [hit for f in files for hit in _imports_of_jax_package(f)] == []


def test_no_source_imports_the_root_bench():
    """The port and chip_smoke.py import nothing of the root bench.py (the
    JAX package's benchmark): the port's bench is audio_modem_tpu_torch.bench."""
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else []
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.name}:{node.lineno} {n}" for n in names if n == "bench" or n.startswith("bench.")]
    assert found == []


def test_plots_import_without_matplotlib():
    """utils.plots imports matplotlib only when it draws, so the port (the
    CLI and diag included) imports on a machine without matplotlib."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'audio_modem_tpu', 'matplotlib'):\n"
        "    sys.modules[blocked] = None\n"
        "import audio_modem_tpu_torch.utils.plots as plots, audio_modem_tpu_torch.cli, audio_modem_tpu_torch.diag\n"
        "try:\n"
        "    plots.plot_ber_curve({0.0: 0.1}, 'never.png')\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_compute_device_does_not_clash_with_the_audio_device():
    """``--torch-device`` is a top-level option; ``--device`` stays the audio
    device of listen and play."""
    from audio_modem_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="--torch-device cpu"):
        cli.main(["listen", "--device", "auto"])
    with pytest.raises(SystemExit):
        cli.main(["--torch-device", "tpu", "info"])


def test_card_only_tests_import_nothing_of_jax():
    """tests/test_torch_cuda.py runs on a machine that has the port but not
    JAX: it imports neither ``jax`` nor the JAX package."""
    path = ROOT / "tests" / "test_torch_cuda.py"
    assert _imports_of_jax_package(path) == []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            assert not [a.name for a in node.names if a.name == "jax" or a.name.startswith("jax.")], node.lineno
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not (node.module == "jax" or (node.module or "").startswith("jax.")), node.lineno


@pytest.mark.parametrize("module, name", ENTRY_POINTS, ids=[f"{m.__name__.split('.')[-1]}.{n}" for m, n in ENTRY_POINTS])
def test_entry_points_default_to_the_card(module, name):
    assert inspect.signature(getattr(module, name)).parameters["device"].default == "cuda"


def test_decode_without_device_raises_without_a_card():
    """Without a CUDA device a call that does not name the CPU raises; with
    one it runs there."""
    sig = np.zeros(40000, np.float32)
    if torch.cuda.is_available():
        result, info = api.decode(sig, "QPSK")
        assert isinstance(result, framing.FrameError) and info is None
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decode(sig, "QPSK")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.encode(b"payload", "QPSK")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.decode_chunk_frame(sig, MODES["QPSK"])
    result, info = api.decode(sig, "QPSK", device="cpu")
    assert isinstance(result, framing.FrameError) and info is None


def test_receiver_and_channel_raise_without_a_card():
    """BatchReceiver and apply_channel_np run on the card unless given the
    CPU; without a card they raise, they never run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_receiver.BatchReceiver(MODES["QPSK"], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_receiver.BatchReceiver(MODES["QPSK"], 2, device_ingest=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channel.apply_channel_np(np.zeros(64, np.float32), channel.ChannelSpec(snr_db=10.0))
    rx = multi_receiver.BatchReceiver(MODES["QPSK"], 2, device="cpu")
    assert rx.device.type == "cpu"


def test_tf32_is_off():
    import audio_modem_tpu_torch

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    audio_modem_tpu_torch.assert_full_fp32()


def test_cpu_tensors_take_the_plain_path():
    mode = MODES["QPSK"]
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    sig = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32) * 0.05)
    nv = torch.tensor([4096, 3000], dtype=torch.int32)
    out = receive.decode_fused(sig, nv, torch.zeros(2, dtype=torch.int32), mode, 2)
    assert not out["detected"].any()
    bits = receive.decode_chunks_fused(sig, mode, 2)
    assert bits.shape == (2, 2 * 410) and bits.dtype == torch.int8
    assert torch.equal(receive.decode_chunks_fused_stream(sig, mode, 2), bits)
    out = receive.decode_long_fused(sig, nv, torch.zeros(2, dtype=torch.int32), mode, 2)
    assert not out["detected"].any()
    assert not any(kernels.launch_counts().values())


def test_the_signature_table_is_the_one_list_of_kernels():
    """``_build._SIGNATURES`` names every kernel: the launch counts have
    exactly its keys, each is a C entry ``amtpu_<name>`` of csrc/ (each of
    ``_SIZES`` an ``amtpu_<name>_scratch_floats``), and the wrappers of
    kernels/receive.py launch exactly its kernels and ask for the scratch of
    exactly ``_SIZES``'."""
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts()) == set(_build._SIGNATURES)
    source = "".join(p.read_text() for p in _build._sources())
    for name in _build._SIGNATURES:
        assert f"amtpu_{name}(" in source, name
    for name in _build._SIZES:
        assert name in _build._SIGNATURES and f"amtpu_{name}_scratch_floats(" in source, name
    called = {"launch": set(), "scratch_floats": set()}
    for node in ast.walk(ast.parse(Path(receive.__file__).read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in called:
            called[node.func.id].add(node.args[0].value)
    assert called == {"launch": set(_build._SIGNATURES), "scratch_floats": set(_build._SIZES)}


# the layers above kernels/, which kernels/ must not import
ABOVE_KERNELS = ("parallel", "runtime", "decoder", "api", "arq", "diag")


def _imports_above_kernels(source: str, name: str) -> list[str]:
    """The imports of one source file under kernels/, at module level or
    inside a function, that reach a layer above it."""
    found = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(["audio_modem_tpu_torch", "kernels"][: max(0, 3 - node.level)]) if node.level else ""
            module = ".".join(p for p in (base, node.module or "") if p)
            names = [module] + [f"{module}.{a.name}" for a in node.names]
        else:
            continue
        found += [f"{name}:{node.lineno} {n}" for n in names
                  if any(n == f"audio_modem_tpu_torch.{m}" or n.startswith(f"audio_modem_tpu_torch.{m}.")
                         for m in ABOVE_KERNELS)]
    return found


def test_kernels_import_nothing_above_them():
    """No module under kernels/ imports parallel, runtime, decoder, api, arq
    or diag, at module level or inside a function; the check itself sees
    each form of such an import."""
    files = sorted((PACKAGE / "kernels").glob("*.py"))
    assert len(files) == 3
    assert [hit for f in files for hit in _imports_above_kernels(f.read_text(), f.name)] == []
    seen = {
        "def f():\n    from audio_modem_tpu_torch.parallel import batch\n": "audio_modem_tpu_torch.parallel",
        "from audio_modem_tpu_torch import decoder\n": "audio_modem_tpu_torch.decoder",
        "import audio_modem_tpu_torch.runtime.receiver\n": "audio_modem_tpu_torch.runtime.receiver",
        "from ..arq import RequestFrame\n": "audio_modem_tpu_torch.arq",
        "from .. import api, phy\n": "audio_modem_tpu_torch.api",
    }
    for source, module in seen.items():
        assert [h.split()[-1] for h in _imports_above_kernels(source, "x.py")][:1] == [module], source
    assert _imports_above_kernels("from .. import phy, sync\nfrom . import _build\n", "x.py") == []


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        kernels.runs_on_kernel(torch.zeros(1), torch.zeros(1, device="meta"))
