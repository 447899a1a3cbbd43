"""Torch port: its copies of the JAX package's host code equal the originals.

The port imports nothing of mp3rgain_tpu, so it carries copies of the host
code it needs: the native C++ front-end and byte-surgery core (_native/,
built by native.py), the MP3 front-end (decode/frontend.py), the AAC front-end
(_native/aacdec.cpp, decode/aac_frontend.py, its tables and crafted
streams, the libavcodec encoder of the committed clips), the table
builders and filter coefficients, the buffer pool, the result types, the
crafted streams, the test oracles (testing/mpg123.py, avcodec.py and
fixtures.py: the libmpg123 decoder, the libavcodec decoder and encoder,
the libmp3lame encoder and the standard fixture set), the CLI's host
modules (ape, id3v2, bitstream, mp4meta, utils) and the GUI. Every copy is
held here to its original: the Python copies by their code (docstrings and
comments aside) and by their outputs, the C++ copies by their code lines
and by the outputs of the functions over them, on the committed clips and
the crafted streams.

The three test oracles differ from their originals in one way: each
library is opened and declared on first use. The original's module-level
statements that name a library are, in order, the body of the copy's
_load, and the library's name is a testing.lazylib.LazyLibrary over it;
a fresh interpreter that imports them loads no codec library. Two oracles
are new in the port and held to the JAX package's here:
ops.iir.equal_loudness_scan (the float64 per-sample filter, within rtol
1e-9 on every rate) and testing.reference.reference_gain (equal to
tests/test_replaygain.py::reference_analyze_pcm on the standard fixtures).

gui.py differs from its original in the device its AppState carries and
passes on and in the two strings that name the platform, and in nothing
else. Four more copies must differ, and are held by the rest of their code and by
their outputs: bitstream.find_max_amplitude (the decoded peak runs on a
device the caller names, and a missing card raises instead of falling
back to an estimate), mp4meta (its ctypes declarations live in
native._declare, so importing it loads no library), decode/aac_frontend.py
(the same, for the three AAC unpackers it binds) and native.py (the
library is built and declared on first use; its wrappers of the
byte-surgery entry points are the original's functions, held by code).
"""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu import ape as jape  # noqa: E402
from mp3rgain_tpu import bitstream  # noqa: E402
from mp3rgain_tpu import mp4meta as jmp4  # noqa: E402
from mp3rgain_tpu import native as jnative  # noqa: E402
from mp3rgain_tpu import replaygain as jrg  # noqa: E402
from mp3rgain_tpu.decode import entropy_tables as jet  # noqa: E402
from mp3rgain_tpu.decode import format_tables as jft  # noqa: E402
from mp3rgain_tpu.decode import aac_frontend as jaf  # noqa: E402
from mp3rgain_tpu.decode import frontend as jfe  # noqa: E402
from mp3rgain_tpu.decode import synth_window as jsw  # noqa: E402
from mp3rgain_tpu.decode import tables as jtables  # noqa: E402
from mp3rgain_tpu.ops import coeffs as jcoeffs  # noqa: E402
from mp3rgain_tpu.testing import avcodec  # noqa: E402
from mp3rgain_tpu.testing import craft as jcraft  # noqa: E402
from mp3rgain_tpu.testing import craft_aac as jcraft_aac  # noqa: E402
from mp3rgain_tpu.testing import fixtures  # noqa: E402
from mp3rgain_tpu.testing import mpg123 as jmpg123  # noqa: E402
from mp3rgain_tpu_torch import ape, mp4meta, native, replaygain  # noqa: E402
from mp3rgain_tpu_torch import bitstream as tbitstream  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_frontend  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_tables, format_tables, frontend  # noqa: E402
from mp3rgain_tpu_torch.decode import synth_window, tables  # noqa: E402
from mp3rgain_tpu_torch.decode import synthesis as syn  # noqa: E402
from mp3rgain_tpu_torch.ops import coeffs, iir  # noqa: E402
from mp3rgain_tpu_torch.testing import craft, craft_aac  # noqa: E402
from mp3rgain_tpu_torch.testing import avcodec as tavcodec  # noqa: E402
from mp3rgain_tpu_torch.testing import fixtures as tfixtures  # noqa: E402
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke  # noqa: E402
from mp3rgain_tpu_torch.testing import mpg123 as tmpg123  # noqa: E402
from mp3rgain_tpu_torch.testing import reference  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "mp3rgain_tpu")
PORT_PKG = os.path.join(ROOT, "mp3rgain_tpu_torch")


def _same(a, b, what="value"):
    """Equal in type, dtype, shape and every bit, recursively."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
        return
    assert type(a) is type(b) and (a is None or a == b), what


# --- Python copies: the same code, docstrings and comments aside -------------

PY_COPIES = [
    "decode/tables.py",
    "decode/format_tables.py",
    "decode/aac_format_tables.py",
    "decode/entropy_tables.py",
    "decode/synth_window.py",
    "ops/coeffs.py",
    "utils/bufpool.py",
    "testing/craft.py",
    "testing/craft_aac.py",
    "ape.py",
    "id3v2.py",
    "utils/__init__.py",
    "utils/term.py",
    "utils/progress.py",
]


def _tree(path: str) -> ast.Module:
    """The module's AST without docstrings (comments never reach it)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _code(path: str) -> str:
    return ast.dump(_tree(path))


@pytest.mark.parametrize("rel", PY_COPIES)
def test_python_copy_has_the_original_code(rel):
    assert _code(os.path.join(PORT_PKG, rel)) == _code(os.path.join(JAX_PKG, rel))


def _defs(path: str) -> dict[str, str]:
    """Top-level functions and classes of a module, by name, as code."""
    return {n.name: ast.dump(n) for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _declares_on_lib(node) -> bool:
    """`_lib.mg_....restype = ...` / `.argtypes = ...` at module level."""
    return (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Attribute)
            and isinstance(node.targets[0].value, ast.Attribute)
            and isinstance(node.targets[0].value.value, ast.Name)
            and node.targets[0].value.value.id == "_lib")


@pytest.mark.parametrize("rel,differs", [
    ("bitstream.py", {"find_max_amplitude"}),
    ("mp4meta.py", set()),
    ("decode/aac_frontend.py", set()),
])
def test_python_copy_differs_only_where_it_must(rel, differs):
    """bitstream.py: every function but find_max_amplitude is the
    original's code. mp4meta.py: the original's code without its ctypes
    declarations, which the port makes in native._declare."""
    def body(path):
        keep = [n for n in _tree(path).body if not _declares_on_lib(n)
                and getattr(n, "name", None) not in differs]
        return [ast.dump(n) for n in keep]

    mine, theirs = os.path.join(PORT_PKG, rel), os.path.join(JAX_PKG, rel)
    assert body(mine) == body(theirs)
    assert set(_defs(mine)) == set(_defs(theirs))


GUI_DIFFERENCES = [  # (the port's text, the original's, occurrences)
    ('    device: str = "cuda"  # where the analysis runs\n', "", 1),
    ("replaygain.analyze_track(entry.path, device=self.device)",
     "replaygain.analyze_track(entry.path)", 1),
    ("replaygain.analyze_album(paths, device=self.device)",
     "replaygain.analyze_album(paths)", 1),
    ("scan_files(paths, progress_cb=_on_file, device=self.device)",
     "scan_files(paths, progress_cb=_on_file)", 1),
    ('def main(argv=None, *, device: str = "cuda") -> int:', "def main(argv=None) -> int:", 1),
    ("state = AppState(device=device)", "state = AppState()", 1),
    ("mp3rgui (CUDA)", "mp3rgui (TPU)", 2),
    ("ReplayGain analysis on PyTorch", "ReplayGain analysis on JAX", 1),
]


def test_gui_copy_differs_only_in_the_device_and_the_platform_name(tmp_path):
    """gui.py with its eight differences taken back is the original's
    code: AppState.device, its three uses, main's argument, and the
    title and About strings."""
    text = open(os.path.join(PORT_PKG, "gui.py")).read()
    for mine, theirs, n in GUI_DIFFERENCES:
        assert text.count(mine) == n, mine
        text = text.replace(mine, theirs)
    back = tmp_path / "gui.py"
    back.write_text(text)
    assert _code(str(back)) == _code(os.path.join(JAX_PKG, "gui.py"))


def test_native_wrappers_are_the_original_functions():
    """native.py's byte-surgery and APEv2 wrappers (the original's
    functions, unchanged)."""
    mine = _defs(os.path.join(PORT_PKG, "native.py"))
    theirs = _defs(os.path.join(JAX_PKG, "native.py"))
    names = ["_MgAnalysis", "_mutbuf", "Analysis", "analyze", "apply_gain",
             "apply_gain_channel", "read_gains", "frame_index", "find_audio_end",
             "read_bits8", "write_bits8", "ape_find_footer", "ape_parse",
             "ape_serialize", "ape_remove_region"]
    assert set(names) <= set(mine)
    for name in names:
        assert mine[name] == theirs[name], name


# --- C++ copies: the same code lines, comments aside --------------------------

def _code_lines(path: str) -> list[str]:
    out = []
    for ln in open(path).read().splitlines():
        s = ln.strip()
        if s and not s.startswith("//"):
            out.append(ln.rstrip())
    return out


NATIVE_SOURCES = ["bitstream.cpp", "ape.cpp", "mp3dec.cpp", "mp4box.cpp", "aacdec.cpp"]


@pytest.mark.parametrize("name", NATIVE_SOURCES + ["huffman_tables.h", "aac_tables.h"])
def test_native_copy_has_the_original_code(name):
    mine = _code_lines(os.path.join(PORT_PKG, "_native", name))
    theirs = _code_lines(os.path.join(JAX_PKG, "_native", name))
    assert mine == theirs


def test_aac_tables_copy_is_byte_equal():
    with open(os.path.join(PORT_PKG, "_native", "aac_tables.h"), "rb") as f:
        mine = f.read()
    with open(os.path.join(JAX_PKG, "_native", "aac_tables.h"), "rb") as f:
        assert mine == f.read()


def test_native_header_declares_the_sources_entry_points():
    """The port's native.h declares exactly the C entry points that the
    originals of its five sources define, with their signatures, and every
    one the port binds."""
    sig = r"\w+\s*\**\s*mg_\w+\s*\([^)]*\)"

    def found(text, end):
        return {" ".join(d.split())[: -len(end)].strip()
                for d in re.findall(sig + r"\s*" + re.escape(end), text)}

    mine = found(" ".join(_code_lines(os.path.join(PORT_PKG, "_native", "native.h"))), ";")
    defined = set()
    for name in NATIVE_SOURCES:
        defined |= found(" ".join(_code_lines(os.path.join(JAX_PKG, "_native", name))), "{")
    assert mine == defined
    assert native.SOURCES == NATIVE_SOURCES
    bound = {"mg_mp3_unpack", "mg_mp3_unpack_light", "mg_mp3_unpack_light2",
             "mg_mp3_count_gch", "mg_entropy_pack4", "mg_sort_est_bits",
             "mg_pack_light_track", "mg_mp4_is_mp4"} | set(SURGERY_ENTRY_POINTS) | set(
                 AAC_ENTRY_POINTS)
    assert all(any(f" {n}(" in d for d in mine) for n in bound)


class _Fn:
    pass


class _Lib:
    """Records the ctypes declarations made on it."""

    def __getattr__(self, name):
        fn = _Fn()
        setattr(self, name, fn)
        return fn


SURGERY_ENTRY_POINTS = [
    "mg_analyze", "mg_apply_gain", "mg_apply_gain_channel", "mg_read_gains",
    "mg_frame_index", "mg_find_audio_end", "mg_read_bits8", "mg_write_bits8",
    "mg_ape_find_footer", "mg_ape_parse", "mg_ape_serialize",
    "mg_ape_remove_region", "mg_mp4_is_mp4", "mg_mp4_read_tags",
    "mg_mp4_write_tags",
]


AAC_ENTRY_POINTS = ["mg_aac_unpack_adts", "mg_aac_unpack_adts_f16",
                    "mg_aac_unpack_adts_q"]


@pytest.mark.parametrize("name", ["mg_mp3_unpack", "mg_mp3_unpack_light",
                                  "mg_mp3_count_gch", "mg_mp3_unpack_light2"]
                         + SURGERY_ENTRY_POINTS + AAC_ENTRY_POINTS)
def test_native_signatures_equal_the_front_end_originals(name):
    mine = _Lib()
    native._declare(mine)
    theirs = getattr(jnative._lib, name)
    assert _ctype(getattr(mine, name).restype) == _ctype(theirs.restype)
    assert ([_ctype(t) for t in getattr(mine, name).argtypes]
            == [_ctype(t) for t in theirs.argtypes])


def _ctype(t):
    """A ctypes type by what it is: a pointer by its target, a structure by
    its fields (the two packages each define mg_analyze's structure)."""
    if t is None or not hasattr(t, "_type_") and not hasattr(t, "_fields_"):
        return t
    if hasattr(t, "_fields_"):
        return ("struct", tuple((n, _ctype(ft)) for n, ft in t._fields_))
    if isinstance(t._type_, type):
        return ("pointer", _ctype(t._type_))
    return t


def test_native_build_is_atomic_under_a_race(tmp_path):
    """Processes that race for the first build all load a whole library;
    one compiler output is left, and no temporary file."""
    prog = (
        "import ctypes, sys\n"
        "import mp3rgain_tpu_torch.native as n\n"
        f"n.BUILD_DIR = {str(tmp_path)!r}\n"
        "n.SO_PATH = n.os.path.join(n.BUILD_DIR, 'libhost.so')\n"
        "lib = ctypes.CDLL(n.build())\n"
        "n._declare(lib)\n"
        "data = open(sys.argv[1], 'rb').read()\n"
        "print(lib.mg_mp3_count_gch(n._inbuf(data), len(data)))\n"
    )
    clip = os.path.join(smoke.DATA_DIR, smoke.TRANSIENT_TRACK)
    procs = [subprocess.Popen([sys.executable, "-c", prog, clip], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e for _, e in outs]
    want = jfe.unpack_data(open(clip, "rb").read()).n
    assert [int(o) for o, _ in outs] == [want] * 3
    assert sorted(os.listdir(tmp_path)) == ["libhost.so", "libhost.so.lock"]


# --- the front-end's outputs, array for array ---------------------------------

def _clip(name: str) -> bytes:
    with open(os.path.join(smoke.DATA_DIR, name), "rb") as f:
        return f.read()


STREAMS = {
    "bench": lambda: _clip(smoke.BENCH_TRACK),
    "mono_22k": lambda: _clip(smoke.MONO_TRACK),
    "transient": lambda: _clip(smoke.TRANSIENT_TRACK),
    "truncated": lambda: _clip(smoke.TRANSIENT_TRACK)[:20000],
    "craft_intensity": jcraft.craft_intensity_stream,
    "craft_mixed_block": jcraft.craft_mixed_block_stream,
    "craft_count1b": jcraft.craft_count1b_stream,
    "craft_scalefactor": lambda: jcraft.craft_scalefactor_stream(
        scf=[3, 2, 1, 4, 5, 6, 7, 0, 1, 2, 3] + [1, 2, 3, 0, 1, 2, 3, 0, 1, 2],
        preflag=1, scfsi=0b1010),
    "craft_lsf_intensity": jcraft.craft_lsf_intensity_stream,
}


def _md_written(meta: np.ndarray) -> np.ndarray:
    """The md bytes the native walk writes: a row with a Huffman window
    holds ceil((p0 + p23) / 8) + 8 window bytes and 8 zeros (mp3dec.cpp,
    the light walk); the rest of the row is never written nor read."""
    p0 = meta[:, frontend.LM_P0].astype(np.int64)
    p23 = meta[:, frontend.LM_P23].astype(np.int64)
    nbytes = np.minimum((p0 + p23 + 7) // 8 + 16, frontend.MD_STRIDE)
    nbytes[p0 + p23 == 0] = 0
    return np.arange(frontend.MD_STRIDE)[None, :] < nbytes[:, None]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_front_end_outputs_equal_the_original(name):
    data = STREAMS[name]()
    for fn in ("unpack_data", "unpack_data_light", "unpack_data_light_packed"):
        mine = getattr(frontend, fn)(data)
        theirs = getattr(jfe, fn)(data)
        assert mine.n > 0, (name, fn)
        if fn != "unpack_data":
            _same(mine.meta, theirs.meta, f"{name}.{fn}.meta")
            written = _md_written(mine.meta)
            assert written.any()
            _same(mine.md[written], theirs.md[written], f"{name}.{fn}.md")
            mine.md = theirs.md = None
        _same(mine, theirs, f"{name}.{fn}")


def test_front_end_helpers_and_constants_equal_the_original():
    names = [k for k, v in vars(jfe).items()
             if k.isupper() and isinstance(v, (int, float, tuple, list))]
    assert len(names) > 20
    for k in names:
        _same(getattr(frontend, k), getattr(jfe, k), k)
    u = jfe.unpack_data(_clip(smoke.TRANSIENT_TRACK))
    _same(frontend.pack_info_light(u.info), jfe.pack_info_light(u.info), "info")
    _same(frontend.pack_scf_rows(u.scf), jfe.pack_scf_rows(u.scf), "scf")


# --- the AAC front-end's outputs, array for array -----------------------------------

def _mp4_adts(name: str) -> bytes:
    data = _clip(name)
    return jaf.mp4_to_adts(data) if data[4:8] == b"ftyp" else data


AAC_STREAMS = {
    "transient": lambda: _mp4_adts(smoke.AAC_TRANSIENT_TRACK),
    "pns": lambda: _mp4_adts(smoke.AAC_PNS_TRACK),
    "mono_22k": lambda: _mp4_adts(smoke.AAC_ADTS_TRACK),
    "truncated": lambda: _mp4_adts(smoke.AAC_PNS_TRACK)[:20000],
    "craft_sce_pulses": lambda: jcraft_aac.craft_sce_stream(
        8, global_gain=140, band_quads=[(1, 0, -1, 0), (0, 1, 0, 0)],
        pulses=[(0, 2), (3, 7)], pulse_start_sfb=1),
    "craft_sce_tns": lambda: jcraft_aac.craft_sce_stream(
        6, n_bands=40, global_gain=140, energy={b: (1, -1, 1, 0) for b in range(30)},
        tns=dict(length=40, order=3, coefs=[5, 2, 7])),
    "craft_cpe_is_ms": lambda: jcraft_aac.craft_cpe_stream(
        8, global_gain=140, n_bands=20, left_energy={b: (1, -1, 1, 0) for b in range(12)},
        is_bands={12: (15, 4), 13: (14, 3)}, ms_used={12, 13, 2, 4}),
}


@pytest.mark.parametrize("name", sorted(AAC_STREAMS))
def test_aac_front_end_outputs_equal_the_original(name):
    data = AAC_STREAMS[name]()
    for fn, kw in (("unpack_adts", {}), ("unpack_adts", {"f16": True}),
                   ("unpack_adts_q", {})):
        mine = getattr(aac_frontend, fn)(data, **kw)
        theirs = getattr(jaf, fn)(data, **kw)
        assert mine.n > 0, (name, fn)
        _same(mine, theirs, f"{name}.{fn}")


def test_aac_demux_and_constants_equal_the_original(tmp_path):
    names = [k for k, v in vars(jaf).items()
             if k.isupper() and isinstance(v, (int, dict))]
    assert len(names) >= 16
    for k in names:
        _same(getattr(aac_frontend, k), getattr(jaf, k), k)
    two = _clip(smoke.AAC_TWO_TRACKS)
    for track in (None, 0, 1):
        adts = aac_frontend.mp4_to_adts(two, track_index=track)
        assert adts == jaf.mp4_to_adts(two, track_index=track) and len(adts) > 1000
    for mod in (aac_frontend, jaf):
        with pytest.raises(mod.Mp4DemuxError, match="Track index 2 out of range"):
            mod.mp4_to_adts(two, track_index=2)
        with pytest.raises(mod.Mp4DemuxError, match="No moov box"):
            mod.mp4_to_adts(two[:24])
    path = os.path.join(smoke.DATA_DIR, smoke.AAC_TWO_TRACKS)
    _same(aac_frontend.unpack_file_q(path, track_index=1),
          jaf.unpack_file_q(path, track_index=1), "unpack_file_q")
    _same(aac_frontend.unpack_file(path, f16=True), jaf.unpack_file(path, f16=True),
          "unpack_file")


# --- the builders' outputs ------------------------------------------------------

def test_table_builders_bit_identical():
    _same(tables.build_tables(), jtables.build_tables(), "build_tables")
    for sr_row in range(9):
        _same(tables.row_tables(sr_row), jtables.row_tables(sr_row), f"row {sr_row}")
    _same(tables.CLASS_OF_KIND, jtables.CLASS_OF_KIND, "CLASS_OF_KIND")
    for bt in range(4):
        _same(tables._window_long(bt), jtables._window_long(bt), f"window {bt}")


def test_format_tables_and_synth_window_bit_identical():
    for k in ("BAND_SIZE_LONG", "BAND_SIZE_SHORT", "PRETAB", "SR_ROW"):
        _same(getattr(format_tables, k), getattr(jft, k), k)
    _same(synth_window.SYNTH_WINDOW_D, jsw.SYNTH_WINDOW_D, "SYNTH_WINDOW_D")


def test_entropy_luts_bit_identical():
    """The copy parses the port's own huffman_tables.h."""
    assert os.path.samefile(os.path.dirname(entropy_tables._header_path()),
                            os.path.join(PORT_PKG, "_native"))
    _same(entropy_tables.build_luts(), jet.build_luts(), "build_luts")


def test_filter_coefficients_bit_identical():
    for k in ("YULE_A", "YULE_B", "BUTTER_A", "BUTTER_B", "SUPPORTED_RATES",
              "DENORMAL_PREVENTION"):
        _same(getattr(coeffs, k), getattr(jcoeffs, k), k)
    assert coeffs.DEGENERATE_RATES == jcoeffs.DEGENERATE_RATES
    for rate in coeffs.SUPPORTED_RATES:
        _same(coeffs.filter_plan(rate), jcoeffs.filter_plan(rate), f"plan {rate}")


def test_result_types_equal_the_original():
    assert replaygain.PINK_REF == jrg.PINK_REF
    for cls in ("ReplayGainResult", "AlbumGainResult", "PeakAmplitudeResult"):
        mine = [(f.name, f.type) for f in dataclasses.fields(getattr(replaygain, cls))]
        theirs = [(f.name, f.type) for f in dataclasses.fields(getattr(jrg, cls))]
        assert mine == theirs, cls
    for db in np.linspace(-40.0, 40.0, 321).tolist() + [0.75, -0.75, 2.25, -2.25]:
        assert replaygain.db_to_steps(db) == bitstream.db_to_steps(db), db
    r = replaygain.ReplayGainResult(90.0, -4.5, 0.5, 44100, "mp3")
    assert r.gain_steps() == jrg.ReplayGainResult(90.0, -4.5, 0.5, 44100, "mp3").gain_steps()


# --- the crafted streams and the encoder, byte for byte -------------------------

CRAFTED = [
    ("craft_intensity_stream", {}),
    ("craft_intensity_stream", {"mode_extension": 3, "ch1_bands": [0, 1, 2]}),
    ("craft_mixed_block_stream", {}),
    ("craft_mixed_block_stream", {"n_frames": 7, "subblock_gain": (2, 0, 1)}),
    ("craft_count1b_stream", {}),
    ("craft_scalefactor_stream", {"scf": [1] * 11 + [2] * 10, "scalefac_scale": 1}),
    ("craft_lsf_intensity_stream", {}),
    ("craft_lsf_intensity_stream", {"intensity_scale": 1}),
]


@pytest.mark.parametrize("fn,kw", CRAFTED)
def test_crafted_streams_byte_identical(fn, kw):
    mine = getattr(craft, fn)(**kw)
    assert mine == getattr(jcraft, fn)(**kw) and len(mine) > 0


AAC_CRAFTED = [
    ("craft_sce_stream", {"n_frames": 4, "global_gain": 140,
                          "band_quads": [(1, 0, -1, 0), (1, 1, 1, 1)]}),
    ("craft_sce_stream", {"n_frames": 3, "global_gain": 120, "band_quads": [(0, 1, 0, 0)],
                          "pulses": [(0, 3)]}),
    ("craft_cpe_stream", {"n_frames": 4, "global_gain": 140, "n_bands": 20,
                          "left_energy": {b: (1, -1, 1, 0) for b in range(12)},
                          "ms_used": {1, 3, 5}}),
]


@pytest.mark.parametrize("fn,kw", AAC_CRAFTED)
def test_crafted_aac_streams_byte_identical(fn, kw):
    """The copy parses the port's own aac_tables.h."""
    assert os.path.samefile(craft_aac._TABLES_H,
                            os.path.join(PORT_PKG, "_native", "aac_tables.h"))
    mine = getattr(craft_aac, fn)(**kw)
    assert mine == getattr(jcraft_aac, fn)(**kw) and len(mine) > 0


@pytest.mark.parametrize("channels,sr,bitrate", [(2, 44100, 128000), (1, 22050, 48000),
                                                 (2, 48000, 192000)])
def test_aac_encoder_copy_byte_identical(channels, sr, bitrate):
    pcm = _pcm(channels, sr, sr + channels).astype(np.float32) / 32768.0
    mine = tavcodec.encode_adts(pcm, sr, bitrate=bitrate)
    assert mine == avcodec.encode_adts(pcm, sr, bitrate=bitrate) and len(mine) > 1000
    if channels == 2:
        other = _pcm(1, 32000, 5).astype(np.float32) / 32768.0
        assert (tfixtures.encode_m4a_multi([(pcm, sr), (other, 32000)], bitrate=bitrate)
                == fixtures.encode_m4a_multi([(pcm, sr), (other, 32000)], bitrate=bitrate))
        assert tfixtures.encode_m4a(pcm, sr, bitrate) == fixtures.encode_m4a(pcm, sr, bitrate)


def test_committed_aac_clips_are_what_the_generator_encodes():
    """The short clips, encoded again (the 60 s one is left out for time)."""
    want = dict(
        [(smoke.AAC_TRANSIENT_TRACK,
          smoke.encode_m4a(smoke._float(smoke.transient_pcm()), 44100, bitrate=128000)),
         (smoke.AAC_PNS_TRACK, smoke.encode_m4a(smoke.pns_pcm(), 44100, bitrate=96000)),
         (smoke.AAC_ADTS_TRACK,
          smoke.encode_adts(smoke._float(smoke.mono_pcm()), 22050, bitrate=48000))])
    for name, data in want.items():
        assert _clip(name) == data, name


def _require(*names: str) -> None:
    """Skip unless the codec libraries that encode the clips load."""
    import ctypes

    try:
        for name in names:
            ctypes.CDLL(name, mode=ctypes.RTLD_GLOBAL)
    except OSError as e:
        pytest.skip(f"no {name} to encode with ({e})")


def test_committed_standard_fixtures_are_what_the_generator_encodes(tmp_path):
    """testing/data/standard/ holds generate_standard_fixtures' 12 files."""
    _require("libmp3lame.so.0")
    fresh = tfixtures.generate_standard_fixtures(tmp_path)
    committed = smoke.standard_paths()
    assert [os.path.basename(p) for p in committed] == sorted(os.listdir(fresh))
    for p in committed:
        with open(p, "rb") as f:
            assert f.read() == (fresh / os.path.basename(p)).read_bytes(), p


def test_committed_adts_rate_clips_are_what_the_generator_encodes():
    _require("libavutil.so.57", "libswresample.so.4", "libavcodec.so.59")
    clips = smoke.adts_rate_clips()
    assert sorted(os.listdir(smoke.ADTS_DIR)) == sorted(name for name, _ in clips)
    for name, data in clips:
        with open(os.path.join(smoke.ADTS_DIR, name), "rb") as f:
            assert f.read() == data, name


def test_crc_protection_byte_identical():
    frame = craft.craft_joint_stereo_frame(1, [0] * 10, [11, 12])
    assert frame == jcraft.craft_joint_stereo_frame(1, [0] * 10, [11, 12])
    assert craft.add_crc_protection(frame, 32) == jcraft.add_crc_protection(frame, 32)


def _pcm(channels: int, sr: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(sr * 0.3)
    wave = 0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / sr) + 0.05 * rng.standard_normal(n)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    return pcm if channels == 1 else np.stack([pcm, np.roll(pcm, 7)], axis=1)


@pytest.mark.parametrize("channels,sr,kw", [
    (2, 44100, {"bitrate": 192, "mode": tfixtures.MODE_JOINT}),
    (2, 44100, {"bitrate": 128, "mode": tfixtures.MODE_STEREO}),
    (1, 22050, {"bitrate": 48, "mode": tfixtures.MODE_MONO}),
    (2, 48000, {"vbr": True, "vbr_quality": 2}),
    (2, 32000, {"bitrate": 96, "write_vbr_tag": False}),
])
def test_encoder_copy_byte_identical(channels, sr, kw):
    assert (tfixtures.MODE_STEREO, tfixtures.MODE_JOINT, tfixtures.MODE_MONO) == (
        fixtures.MODE_STEREO, fixtures.MODE_JOINT, fixtures.MODE_MONO)
    pcm = _pcm(channels, sr, sr + channels)
    mine = tfixtures.encode_mp3(pcm, sr, **kw)
    assert mine == fixtures.encode_mp3(pcm, sr, **kw) and len(mine) > 1000


# --- the byte-surgery core's outputs ----------------------------------------------

@pytest.mark.parametrize("name", ["bench", "mono_22k", "transient", "truncated",
                                  "craft_intensity", "craft_mixed_block"])
def test_byte_surgery_outputs_equal_the_original(name):
    data = STREAMS[name]()
    for fn in ("read_gains", "frame_index", "find_audio_end"):
        _same(getattr(native, fn)(data), getattr(jnative, fn)(data), f"{name}.{fn}")
    _same(native.analyze(data), jnative.analyze(data), f"{name}.analyze")
    assert native.read_bits8(data, 100, 3) == jnative.read_bits8(data, 100, 3)
    for steps, wrap in ((2, False), (-3, False), (200, True)):
        mine, theirs = bytearray(data), bytearray(data)
        assert native.apply_gain(mine, steps, wrap) == jnative.apply_gain(theirs, steps, wrap)
        assert mine == theirs, (name, steps, wrap)
    for channel in (0, 1):
        mine, theirs = bytearray(data), bytearray(data)
        assert (native.apply_gain_channel(mine, channel, -2)
                == jnative.apply_gain_channel(theirs, channel, -2))
        assert mine == theirs, (name, channel)
    mine, theirs = bytearray(data), bytearray(data)
    native.write_bits8(mine, 200, 5, 0xA5)
    jnative.write_bits8(theirs, 200, 5, 0xA5)
    assert mine == theirs


def test_ape_outputs_equal_the_original():
    data = _clip(smoke.TRANSIENT_TRACK)
    items = [(b"MP3GAIN_UNDO", b"+002,+002,N"), (b"MP3GAIN_MINMAX", b"120,210"),
             (b"REPLAYGAIN_TRACK_GAIN", b"-6.70 dB")]
    tag = native.ape_serialize(items)
    assert tag == jnative.ape_serialize(items) and len(tag) > 64
    tagged = data + tag
    for fn in ("ape_find_footer", "ape_parse", "ape_remove_region"):
        _same(getattr(native, fn)(tagged), getattr(jnative, fn)(tagged), fn)
        _same(getattr(native, fn)(data), getattr(jnative, fn)(data), fn)
    mine, theirs = ape.read_ape_tag(tagged), jape.read_ape_tag(tagged)
    assert mine.items == theirs.items
    assert ape.serialize_ape_tag(mine) == jape.serialize_ape_tag(theirs)
    assert ape.remove_ape_tag(tagged) == jape.remove_ape_tag(tagged) == data
    assert (ape.write_ape_tag_to_data(data, mine)
            == jape.write_ape_tag_to_data(data, theirs))
    assert ape.parse_undo_values("+002,-001,N") == jape.parse_undo_values("+002,-001,N")


def _box(kind: bytes, payload: bytes) -> bytes:
    return (8 + len(payload)).to_bytes(4, "big") + kind + payload


def test_mp4meta_outputs_equal_the_original(tmp_path):
    """A minimal ISO-BMFF file (ftyp, moov/trak/.../stco, mdat): the sniff,
    and ReplayGain tags written, read back and deleted."""
    stco = _box(b"stco", bytes(4) + (1).to_bytes(4, "big") + (0).to_bytes(4, "big"))
    moov = _box(b"moov", _box(b"trak", _box(b"mdia", _box(b"minf", _box(b"stbl", stco)))))
    m4a = _box(b"ftyp", b"M4A " + bytes(4) + b"M4A mp42isom") + moov + _box(
        b"mdat", bytes(range(64)))
    mp3 = tmp_path / "a.mp3"
    mp3.write_bytes(_clip(smoke.TRANSIENT_TRACK))
    path = tmp_path / "a.m4a"
    path.write_bytes(m4a)
    assert mp4meta.is_mp4_file(path) and jmp4.is_mp4_file(path)
    assert not mp4meta.is_mp4_file(mp3) and not jmp4.is_mp4_file(mp3)
    tags, jtags = mp4meta.ReplayGainTags(), jmp4.ReplayGainTags()
    for t in (tags, jtags):
        t.set_track(-6.5, 0.98765)
        t.set_album(-7.25, 0.99)
    written = mp4meta.write_replaygain_tags_to_data(m4a, tags)
    assert written == jmp4.write_replaygain_tags_to_data(m4a, jtags) != m4a
    _same(mp4meta.read_replaygain_tags_from_data(written),
          jmp4.read_replaygain_tags_from_data(written), "tags")
    mine, theirs = tmp_path / "m.m4a", tmp_path / "t.m4a"
    for p, mod, t in ((mine, mp4meta, tags), (theirs, jmp4, jtags)):
        p.write_bytes(m4a)
        mod.write_replaygain_tags(p, t)
        mod.delete_replaygain_tags(p)
    assert mine.read_bytes() == theirs.read_bytes()


def test_find_max_amplitude_matches_the_original(tmp_path):
    """The one bitstream function that differs: the gains read equal, the
    decoded peak (the port's pipeline on the CPU) within rtol 2e-4, and
    without a card the default device raises instead of estimating."""
    path = tmp_path / "t.mp3"
    path.write_bytes(_clip(smoke.TRANSIENT_TRACK))
    peak, max_gain, min_gain = tbitstream.find_max_amplitude(path, device="cpu")
    j_peak, j_max, j_min = bitstream.find_max_amplitude(path)
    assert (max_gain, min_gain) == (j_max, j_min)
    np.testing.assert_allclose(peak, j_peak, rtol=2e-4)
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"\0" * 4096)
    with pytest.raises(tbitstream.Mp3Error):
        tbitstream.find_max_amplitude(bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(replaygain.DeviceUnavailable):
            tbitstream.find_max_amplitude(path)


# --- the test oracles: the originals, their libraries loaded on first use ------------

TESTING_COPIES = {
    "testing/mpg123.py": ("_m",),
    "testing/avcodec.py": ("_avu", "_swr", "_avc"),
    "testing/fixtures.py": ("_lame",),
}
LAZY_IMPORTS = {"from .lazylib import LazyLibrary", "from functools import lru_cache"}


@pytest.mark.parametrize("rel", sorted(TESTING_COPIES))
def test_testing_copy_is_the_original_with_lazy_loads(rel):
    """The original's module-level statements that name a library are, in
    order, the body of the copy's _load (which returns the libraries);
    each library name is a LazyLibrary; every other statement, function
    and class is the original's, in order; the copy adds no import but
    the two the lazy loads need."""
    libs = TESTING_COPIES[rel]
    theirs = _tree(os.path.join(JAX_PKG, rel)).body
    mine = _tree(os.path.join(PORT_PKG, rel)).body

    def is_import(n):
        return isinstance(n, (ast.Import, ast.ImportFrom))

    def is_load(n):
        return (not isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not is_import(n)
                and any(isinstance(x, ast.Name) and x.id in libs for x in ast.walk(n)))

    loads = [ast.dump(n) for n in theirs if is_load(n)]
    assert len(loads) >= 3
    loader = [n for n in mine if isinstance(n, ast.FunctionDef) and n.name == "_load"]
    assert len(loader) == 1
    loader = loader[0]
    assert [ast.dump(n) for n in loader.body[:-1]] == loads
    ret = loader.body[-1]
    assert isinstance(ret, ast.Return)
    returned = ret.value.elts if isinstance(ret.value, ast.Tuple) else [ret.value]
    assert [n.id for n in returned] == list(libs)

    proxies = [n for n in mine if isinstance(n, ast.Assign)
               and isinstance(n.value, ast.Call)
               and getattr(n.value.func, "id", None) == "LazyLibrary"]
    assert [n.targets[0].id for n in proxies] == list(libs)

    rest = [ast.dump(n) for n in mine
            if n is not loader and n not in proxies and not is_import(n)]
    assert rest == [ast.dump(n) for n in theirs if not is_load(n) and not is_import(n)]
    mine_imports = {ast.unparse(n) for n in mine if is_import(n)}
    theirs_imports = {ast.unparse(n) for n in theirs if is_import(n)}
    assert theirs_imports <= mine_imports
    assert mine_imports - theirs_imports <= LAZY_IMPORTS


def test_mpg123_copy_decodes_the_same_arrays(tmp_path):
    crafted = tmp_path / "intensity.mp3"
    crafted.write_bytes(jcraft.craft_intensity_stream())
    paths = [os.path.join(smoke.DATA_DIR, n) for n in (
        smoke.BENCH_TRACK, smoke.MONO_TRACK, smoke.TRANSIENT_TRACK, smoke.HOT_TRACK)]
    for path in paths + [str(crafted)]:
        mine = tmpg123.decode_file(path)
        assert mine[0].size > 0
        _same(mine, jmpg123.decode_file(path), path)
    _same(tmpg123.decode_file(paths[2], gapless=True),
          jmpg123.decode_file(paths[2], gapless=True), "gapless")


def test_decode_adts_copy_decodes_the_same_arrays():
    streams = [_mp4_adts(smoke.AAC_ADTS_TRACK), _mp4_adts(smoke.AAC_TRANSIENT_TRACK),
               _mp4_adts(smoke.AAC_PNS_TRACK),
               jaf.mp4_to_adts(_clip(smoke.AAC_TWO_TRACKS), track_index=1)]
    for i, data in enumerate(streams):
        mine = tavcodec.decode_adts(data)
        assert mine[0].size > 0
        _same(mine, avcodec.decode_adts(data), f"stream {i}")


def test_standard_fixtures_copy_byte_identical(tmp_path):
    mine = tfixtures.generate_standard_fixtures(tmp_path / "mine")
    theirs = fixtures.generate_standard_fixtures(tmp_path / "theirs")
    names = sorted(os.listdir(mine))
    assert len(names) == 12 and names == sorted(os.listdir(theirs))
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    for kw in ({"sample_rate": 44100}, {"sample_rate": 8000, "seconds": 0.3,
                                       "freq": 1000.0, "amplitude": 0.9, "channels": 1}):
        _same(tfixtures.sine_pcm(**kw), fixtures.sine_pcm(**kw), str(kw))


def test_committed_hot_clip_is_the_peak_contract_clip():
    """hot_5s_44k_128k.mp3 is tests/test_peak_contract.py's clip before
    its +4 gain steps, encoded by the JAX package's encoder."""
    from test_peak_contract import _burst_pcm

    assert np.array_equal(smoke.hot_pcm(), _burst_pcm(0.01, 0.8))
    want = fixtures.encode_mp3(_burst_pcm(0.01, 0.8), 44100, bitrate=128)
    assert _clip(smoke.HOT_TRACK) == want


def test_testing_copies_load_no_codec_library_at_import():
    """A fresh interpreter that imports the oracles, the generator, the
    reference and entry.py has no codec library mapped and no
    LazyLibrary loaded; decoding one clip then maps libmpg123 (the check
    sees a load)."""
    clip = os.path.join(smoke.DATA_DIR, smoke.TRANSIENT_TRACK)
    prog = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from mp3rgain_tpu_torch import entry
from mp3rgain_tpu_torch.testing import avcodec, fixtures, make_smoke_data, mpg123, reference

def mapped():
    names = ("libmpg123", "libavcodec", "libavutil", "libswresample", "libmp3lame")
    with open("/proc/self/maps") as f:
        text = f.read()
    return sorted(n for n in names if n in text)

proxies = [mpg123._m, avcodec._avu, avcodec._swr, avcodec._avc, fixtures._lame]
fixtures.sine_pcm(8000)
before = (mapped(), [p.loaded for p in proxies])
mpg123.decode_file({clip!r})
print(json.dumps({{"before": before, "after": (mapped(), mpg123._m.loaded)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["before"] == [[], [False] * 5]
    assert got["after"] == [["libmpg123"], True]


# --- the two float64 oracles ----------------------------------------------------------


@pytest.mark.parametrize("rate", coeffs.SUPPORTED_RATES)
def test_equal_loudness_scan_equals_the_original(rate):
    """The port's lfilter oracle against the JAX per-sample scan, within
    rtol 1e-9 and atol 1e-9·max|ref|. At the degenerate 88.2 kHz row both
    overflow; they agree on every sample before either turns non-finite,
    and both do so within a few samples of each other."""
    import jax.numpy as jnp
    from test_replaygain import iir as jiir

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4096)) * 0.3 * 32768.0
    ref = np.asarray(jiir.equal_loudness_scan(jnp.asarray(x), rate))
    got = iir.equal_loudness_scan(x, rate)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    got = got.numpy()
    if rate in coeffs.DEGENERATE_RATES:
        first = [int(np.argmin(np.isfinite(a), axis=-1).min()) for a in (got, ref)]
        assert 1000 < min(first) and abs(first[0] - first[1]) <= 8, first
        got, ref = got[:, : min(first)], ref[:, : min(first)]
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


STANDARD_FIXTURES = ["test_stereo.mp3", "test_mono.mp3", "test_joint_stereo.mp3",
                     "test_vbr.mp3", "test_mpeg2_22050.mp3", "test_mpeg25_11025.mp3",
                     "test_48000.mp3", "test_32000.mp3", "test_mpeg2_24000.mp3",
                     "test_mpeg2_16000.mp3", "test_mpeg25_12000.mp3", "test_mpeg25_8000.mp3"]


@pytest.mark.parametrize("name", STANDARD_FIXTURES)
def test_reference_gain_equals_the_original(fixtures_dir, name):
    """testing.reference.reference_gain against tests/test_replaygain.py's
    reference_analyze_pcm on the same PCM (the port's CPU decode): the
    same gain, exactly; reference_peak is max|pcm|."""
    from test_replaygain import reference_analyze_pcm

    pcm, sr = syn.decode_file(fixtures_dir / name, device="cpu")
    assert reference.reference_gain(pcm, sr) == reference_analyze_pcm(
        pcm.astype(np.float64), sr)
    assert reference.reference_peak(pcm) == float(np.abs(pcm).max()) > 0
