"""The port's surface against the JAX package's, by AST alone (neither
package is imported): every module of ``audio_modem_tpu`` has a counterpart
file at the same path under ``audio_modem_tpu_torch``, and every top-level
name of a JAX module exists in its counterpart or stands in ``NOT_PORTED``
with the reason it does not.

A top-level name is a function, class or assigned name at module level
(inside a module-level ``if`` or ``try`` too), and, in an ``__init__.py``,
a name it re-exports from its own package. On the port's side every import
counts, since a counterpart may take a name from another module.

The list is held both ways: a JAX name in neither place fails, and so does
an entry of ``NOT_PORTED`` that the port now defines or that the JAX
package no longer has. A reason that points at the port's code as
`` `path::name` `` must point at a name that exists there."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "audio_modem_tpu"
PORT_PKG = ROOT / "audio_modem_tpu_torch"

CU = "audio_modem_tpu_torch/csrc/receive.cu"
KR = "audio_modem_tpu_torch/kernels/receive.py"
TABLES = "`audio_modem_tpu_torch/tables.py::Tables`"
# ROADMAP.md, queue 2, "Helpers not to port": Pallas / Mosaic layout with no meaning on a GPU
TPU_LAYOUT = "TPU layout only (ROADMAP 'Helpers not to port')"
LANES = f"{TPU_LAYOUT}: 128-lane pads and 8-row tiles of the Pallas kernels; kernel A tiles by `{CU}::tiling_a`"
FP32 = ("XLA's HIGHEST matmul precision; the port computes in float32 with TF32 off "
        "(`audio_modem_tpu_torch/__init__.py::assert_full_fp32`)")

NOT_PORTED = {
    "decoder:_decode_core": (
        "the XLA single-signal pipeline; the decoder calls kernel A at B = 1, "
        f"`{KR}::decode_fused`, whose CPU path is that pipeline (`{KR}::decode_fused_reference`)"),
    "framing:_synth_frame": (
        "one-frame synthesis; the port synthesizes one frame as a batch of one "
        "(`audio_modem_tpu_torch/framing.py::synthesize_frame` over `audio_modem_tpu_torch/framing.py::_synth_frames_core`)"),
    "kernels:kernels_enabled": (
        f"{TPU_LAYOUT}: the Pallas / XLA switch; a CUDA tensor launches the kernel and a CPU tensor runs "
        "the plain version (`audio_modem_tpu_torch/kernels/__init__.py::runs_on_kernel`)"),
    # the Pallas kernel bodies and their pallas_call wrappers: each is CUDA C++ in csrc/receive.cu
    "kernels.receive:_receive_kernel": f"kernel A's body: `{CU}::amtpu_decode_fused` (six launches)",
    "kernels.receive:_chunk_kernel": f"kernel B's body: `{CU}::amtpu_decode_chunks_fused`",
    "kernels.receive:_chunk_stream_flat_kernel": f"B′'s body (640/768-sample symbols): `{CU}::stream_demod_kernel`",
    "kernels.receive:_chunk_stream_pair_kernel": f"B″'s body (576-sample pairs): `{CU}::stream_demod_kernel`",
    "kernels.receive:_stream_demod_words": f"B′'s pallas_call: `{KR}::stream_demod` (`{CU}::amtpu_stream_demod`)",
    "kernels.receive:_stream_demod_words_pair": f"B″'s pallas_call: `{KR}::stream_demod` (`{CU}::amtpu_stream_demod`)",
    "kernels.receive:_eq_demap_pack": f"in-kernel EQ, pilot phase, demap and pack: the epilogue of `{CU}::demod_tile`",
    "kernels.receive:_demap_bit_planes": f"in-kernel hard demap: `{CU}::demap_index`",
    "kernels.receive:_inverse_gray_i32": f"in-kernel inverse Gray map: `{CU}::qam_axis_bits`",
    "kernels.receive:_words_to_bits": f"unpacks the Pallas kernels' 16-bit words; the CUDA kernels store int8 bits (`{CU}::store_bits`)",
    "kernels.receive:_pack_matrix": f"{TPU_LAYOUT}: one-hot bit-pack matmul; the CUDA kernels store bits (`{CU}::store_bits`)",
    "kernels.receive:_tiled_channel": f"{TPU_LAYOUT}: conj(H)/|H|^2 tiled to MXU row blocks; `{CU}::eq_tables`",
    "kernels.receive:_ce_known_row": f"CE signs in lane sections; {TABLES} (ce_known) and `{CU}::channel_estimate`",
    "kernels.receive:_rx_sections": f"RX DFT in 128-lane sections; `audio_modem_tpu_torch/tables.py::demod_table` (rx_demod)",
    "kernels.receive:_rx_sections_pair": TPU_LAYOUT,
    "kernels.receive:_dot_exact3": TPU_LAYOUT,
    "kernels.receive:_tile_rows": TPU_LAYOUT,
    "kernels.receive:_scan_masks": f"{TPU_LAYOUT}; the scan is `{CU}::scan_kernel`",
    "kernels.receive:_group_syms": TPU_LAYOUT,
    "kernels.receive:_STREAM_SUBGROUPS": TPU_LAYOUT,
    "kernels.receive:fused_receive_fits": f"{TPU_LAYOUT}: VMEM gate; Hopper grids kernel A over tiles at any length",
    "kernels.receive:fused_chunks_fits": f"{TPU_LAYOUT}: VMEM gate; kernel B takes any frame length",
    "kernels.receive:_FUSED_VMEM_BUDGET": f"{TPU_LAYOUT}: the VMEM gates' budget",
    "kernels.receive:_geometry": LANES,
    "kernels.receive:_rx_t_pad": LANES,
    "kernels.receive:_round_up": LANES,
    "kernels.receive:_ROWS": LANES,
    "kernels.receive:_HALF": LANES,
    "kernels.receive:_LANE": LANES,
    "kernels.receive:_SCAN_CHUNK": LANES,
    "kernels.receive:_HI": FP32,
    # jnp_* device helpers: the port's ops take tensors on any device
    "ops.bits:jnp_bits_to_bytes": "jnp device version; `audio_modem_tpu_torch/ops/bits.py::bits_to_bytes` takes tensors",
    "ops.bits:jnp_majority_vote": "jnp device version; `audio_modem_tpu_torch/ops/bits.py::majority_vote` takes tensors",
    "ops.bits:_BIT_SHIFTS": "the numpy unpack's shifts; the port unpacks tensors (`audio_modem_tpu_torch/ops/bits.py::bytes_to_bits`)",
    "ops.constellations:_qam16_points": "`_square_qam_points(2)` under another name; the table calls that directly",
    "ops.constellations:_tables": "point / half-power / bit tables that no caller reads: both packages map and demap in closed form",
    "ops.dft:_PRECISION": FP32,
    "ops.dft:_rx_matrix": "RX DFT table: `audio_modem_tpu_torch/tables.py::_rx_matrix_for_bins` (rx_active)",
    "ops.dft:_rx_matrix_for_bins": "RX DFT table: `audio_modem_tpu_torch/tables.py::_rx_matrix_for_bins`",
    "ops.dft:_tx_matrix": "TX DFT table: `audio_modem_tpu_torch/tables.py::_tx_tables`",
    "ops.dft:dot_bf16x3": TPU_LAYOUT,
    "ops.dft:tx_data_tables": f"{TPU_LAYOUT}; the TX tables are `audio_modem_tpu_torch/tables.py::numpy_tables`",
    "ops.dft:spec_to_time": f"{TPU_LAYOUT}; the TX tables are `audio_modem_tpu_torch/tables.py::numpy_tables`",
    "parallel.batch:_batch_decode_signals_xla": f"the XLA receive: kernel A's plain version `{KR}::decode_fused_reference`",
    "parallel.batch:_batch_decode_chunk_frames_xla": f"the XLA frame demod: kernel B's plain version `{KR}::decode_chunks_fused_reference`",
    "parallel.batch:_single_signal_decode": f"the one-signal body that XLA vmaps; the plain receive is batched (`{KR}::decode_fused_reference`)",
    "parallel.batch:_predicted_signal_decode": (
        f"the one-signal body that XLA vmaps and scans over the predicted slots; `{KR}::decode_predicted` runs the "
        f"slots batched (kernel C, `{CU}::amtpu_decode_predicted`; its plain version "
        "`audio_modem_tpu_torch/parallel/batch.py::batch_decode_predicted` a slot)"),
    "parallel.batch:stream_kernel_preferred": TPU_LAYOUT,
    "parallel.multi_receiver:_ring_append": (
        "the shift ring's write; the port's ring is written in place, chosen on measurement "
        "(`audio_modem_tpu_torch/parallel/multi_receiver.py::DeviceRing`)"),
    "parallel.multihost:COORD_PORT": (
        "a deliberate deviation: a fixed coordinator port; each dry run takes a free port "
        "(`audio_modem_tpu_torch/parallel/multihost.py::_free_port`)"),
    "phy:_bin_tables": f"index tables of the active-bin axis: {TABLES} (data_pos, pilot_pos, ce_known)",
    "sync:_template": f"the preamble template: {TABLES} (pre1, t_energy)",
    "sync:_template_bank": (
        f"{TPU_LAYOUT}: lane-shifted preamble bank for an MXU correlation; "
        "`audio_modem_tpu_torch/sync.py::sliding_correlate`"),
    "sync:_LANE": f"{TPU_LAYOUT}: the template bank's lane width",
}


def _top_level(path: Path, imports: bool) -> set[str]:
    """Top-level names of a module (see the module docstring). ``imports``:
    count every import; otherwise only an ``__init__``'s re-exports."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = path.parent.relative_to(ROOT).parts[0]
    out: set[str] = set()
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.If, ast.Try)):
            stack += node.body + node.orelse + getattr(node, "finalbody", [])
            stack += [s for h in getattr(node, "handlers", []) for s in h.body]
        elif isinstance(node, ast.ImportFrom) and (
            imports or (path.name == "__init__.py" and (node.level or (node.module or "").startswith(pkg)))
        ):
            out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import) and imports:
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _module(rel: Path) -> str:
    return ".".join(rel.with_suffix("").parts).removesuffix("__init__").rstrip(".")


JAX_MODULES = sorted(p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py"))


def _not_ported(module: str) -> dict[str, str]:
    return {k.split(":", 1)[1]: v for k, v in NOT_PORTED.items() if k.split(":", 1)[0] == module}


@pytest.mark.parametrize("rel", JAX_MODULES, ids=str)
def test_module_surface(rel):
    module = _module(rel)
    port = PORT_PKG / rel
    assert port.is_file(), f"audio_modem_tpu/{rel} has no counterpart at audio_modem_tpu_torch/{rel}"
    jax_names = _top_level(JAX_PKG / rel, imports=False)
    port_names = _top_level(port, imports=True)
    excluded = _not_ported(module)
    missing = sorted(jax_names - port_names - set(excluded))
    assert not missing, f"{module}: not in the port and not in NOT_PORTED: {missing}"
    now_ported = sorted(set(excluded) & port_names)
    assert not now_ported, f"{module}: NOT_PORTED lists names the port defines: {now_ported}"
    gone = sorted(set(excluded) - jax_names)
    assert not gone, f"{module}: NOT_PORTED lists names the JAX package no longer has: {gone}"


def test_not_ported_names_modules_of_the_jax_package():
    modules = {_module(rel) for rel in JAX_MODULES}
    stale = sorted(k for k in NOT_PORTED if k.split(":", 1)[0] not in modules)
    assert not stale, f"NOT_PORTED entries of modules the JAX package does not have: {stale}"
    assert all(reason.strip() for reason in NOT_PORTED.values())


def test_reasons_point_at_code_that_exists():
    """Every `path::name` in a reason names a top-level name of that Python
    file, or an identifier of that CUDA source."""
    refs = sorted({m for reason in NOT_PORTED.values() for m in re.findall(r"`([\w/.]+)::(\w+)`", reason)})
    assert refs
    bad = []
    for path, name in refs:
        src = ROOT / path
        if path.endswith(".py"):
            ok = src.is_file() and name in _top_level(src, imports=True)
        else:
            ok = src.is_file() and re.search(rf"\b{name}\b", src.read_text()) is not None
        if not ok:
            bad.append(f"{path}::{name}")
    assert not bad, f"reasons point at names that do not exist: {bad}"
