"""Torch port: it imports nothing of the JAX package and nothing of JAX.

Two checks. An AST scan of every module of mp3rgain_tpu_torch and of
chip_smoke.py finds no import of `mp3rgain_tpu` or `jax` (nor of a
submodule of either), wherever the import stands: at the top, inside a
function or under a condition. And a fresh interpreter that imports
every module of the port has neither name in sys.modules afterwards, nor
a loaded host library or kernel library, nor a codec library that the
test oracles bind (all of those load on first use).
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "mp3rgain_tpu_torch"
FORBIDDEN = ("mp3rgain_tpu", "jax")
CODECS = ("libmpg123", "libavcodec", "libavutil", "libswresample", "libmp3lame")


def _port_files() -> list[str]:
    out = []
    for base, dirs, files in os.walk(os.path.join(ROOT, PORT)):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_build", "__pycache__")))
        out += [os.path.relpath(os.path.join(base, f), ROOT)
                for f in sorted(files) if f.endswith(".py")]
    return out + ["chip_smoke.py"]


def _imported(path: str) -> list[str]:
    """Top-level package names of every absolute import in the file."""
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value).split(".")[0])
    return names


def test_scan_covers_the_port():
    files = _port_files()
    assert "chip_smoke.py" in files and len(files) > 31
    for must in ("analysis.py", "native.py", "decode/frontend.py",
                 "decode/class_core.py", "parallel/runner.py", "scan.py", "cli.py",
                 "bitstream.py", "ape.py", "id3v2.py", "mp4meta.py", "aac.py",
                 "decode/aac_frontend.py", "decode/aac_prep.py",
                 "decode/aac_synthesis.py", "decode/aac_format_tables.py",
                 "testing/craft_aac.py", "testing/make_smoke_data.py", "gui.py",
                 "parallel/multihost.py", "parallel/dryrun.py", "testing/hostile.py",
                 "testing/mpg123.py", "testing/avcodec.py", "testing/fixtures.py",
                 "testing/reference.py", "testing/lazylib.py", "entry.py"):
        assert os.path.join(PORT, must) in files, must


@pytest.mark.parametrize("rel", _port_files())
def test_module_imports_neither_jax_nor_the_jax_package(rel):
    bad = [n for n in _imported(os.path.join(ROOT, rel)) if n in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_a_forbidden_import(tmp_path):
    """The scanner itself: each spelling of the imports it must catch."""
    src = tmp_path / "m.py"
    for line in ("import jax", "import jax.numpy as jnp",
                 "from mp3rgain_tpu.decode import frontend",
                 "def f():\n    from mp3rgain_tpu import native",
                 "import importlib\nimportlib.import_module('jax')"):
        src.write_text(line + "\n")
        assert set(_imported(str(src))) & set(FORBIDDEN), line
    src.write_text("from . import native\nimport mp3rgain_tpu_torch.native\n")
    assert not set(_imported(str(src))) & set(FORBIDDEN)


def test_fresh_interpreter_importing_the_port_loads_neither():
    prog = f"""
import importlib, json, os, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import {PORT}
names = []
for m in pkgutil.walk_packages({PORT}.__path__, "{PORT}."):
    importlib.import_module(m.name)
    names.append(m.name)
import chip_smoke
from {PORT} import _build, native
with open("/proc/self/maps") as f:
    maps = f.read()
print(json.dumps({{
    "modules": names,
    "loaded": sorted(k for k in sys.modules
                     if k.split(".")[0] in {FORBIDDEN!r}),
    "host_library_loaded": native._lib._lib is not None,
    "kernel_library_loaded": _build._lib is not None,
    "codec_libraries": sorted(n for n in {CODECS!r} if n in maps),
}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert f"{PORT}.decode.frontend" in got["modules"]
    assert f"{PORT}.tools.hk_dotprobe" in got["modules"]
    for name in ("aac", "decode.aac_frontend", "decode.aac_prep", "decode.aac_synthesis",
                 "testing.craft_aac", "gui", "parallel.multihost", "parallel.dryrun",
                 "testing.mpg123", "testing.avcodec", "testing.fixtures",
                 "testing.reference", "entry"):
        assert f"{PORT}.{name}" in got["modules"], name
    assert len(got["modules"]) >= 40
    assert got["loaded"] == []
    assert not got["host_library_loaded"] and not got["kernel_library_loaded"]
    assert got["codec_libraries"] == []


def test_fresh_interpreter_importing_multihost_loads_no_torch():
    """parallel.multihost answers is_multihost() and process_slice() from
    the environment without torch: byte surgery under a coordinator stays
    cheap."""
    prog = f"""
import json, os, sys
sys.path.insert(0, {ROOT!r})
os.environ.update(MP3RGAIN_COORDINATOR="localhost:1", MP3RGAIN_NUM_PROCESSES="3",
                  MP3RGAIN_PROCESS_ID="2")
from {PORT}.parallel import multihost
print(json.dumps({{
    "multihost": multihost.maybe_initialize_from_env(),
    "slice": multihost.process_slice(list(range(7))),
    "loaded": sorted(k for k in sys.modules
                     if k.split(".")[0] in ("torch", *{FORBIDDEN!r})),
}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"multihost": True, "slice": [2, 5], "loaded": []}
