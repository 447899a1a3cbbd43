"""Torch port: the multi-process layer (parallel/multihost.py) and the CLI
inside a process group.

Real subprocesses form gloo groups over TCP on the CPU, each with its own
time limit (the port's CLI has no device flag, so the children call
cli.main(argv, device="cpu")):

- two processes running `-a -n -o json` over four fixture files each
  print their round-robin slice and the album block of a single-process
  run, exactly; that block is within 0.02 dB and peak rtol 2e-4 of the JAX
  CLI's single-process album, gain steps equal;
- three processes over two files: the process with the empty slice joins
  the union and every process exits 0 with the same album (the JAX CLI
  hangs there, so it is not compared);
- a file that fails on one process's slice makes every process refuse the
  album with exit code 1, none waits for another;
- parallel.dryrun.dryrun_multihost(2);
- outside a group process_slice is the identity and is_multihost False;
- a fresh interpreter running `-g 2` under the coordinator loads no torch
  and rewrites only its slice, byte-identical with the JAX CLI there.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from mp3rgain_tpu import cli as jcli  # noqa: E402
from mp3rgain_tpu_torch.parallel import dryrun, multihost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["test_stereo.mp3", "test_joint_stereo.mp3", "test_mono.mp3", "test_vbr.mp3"]
CLI_ON_CPU = ("import sys, torch; torch.set_num_threads(2); "
              "from mp3rgain_tpu_torch import cli; "
              "sys.exit(cli.main(sys.argv[1:], device='cpu'))")
TIMEOUT_S = 300


def _copies(fixtures_dir, where, names=NAMES) -> list[str]:
    where.mkdir()
    out = []
    for i, name in enumerate(names):
        shutil.copy(fixtures_dir / name, where / f"a{i}_{name}")
        out.append(str(where / f"a{i}_{name}"))
    return out


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("MP3RGAIN_")}
    env["MP3RGAIN_GROUP_TIMEOUT_S"] = "120"
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _group(argv, n: int, prog=CLI_ON_CPU):
    """Run `argv` as n processes of one group; [(rc, stdout, stderr)]."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", prog, *argv], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_env(MP3RGAIN_COORDINATOR=f"localhost:{port}",
                 MP3RGAIN_NUM_PROCESSES=str(n), MP3RGAIN_PROCESS_ID=str(pid)))
        for pid in range(n)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT_S)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _doc(stdout: str) -> dict:
    """The CLI's JSON document (gloo may print banners before it)."""
    return json.loads(stdout[stdout.index("{"):])


def _single(argv) -> dict:
    proc = subprocess.run([sys.executable, "-c", CLI_ON_CPU, *argv], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return _doc(proc.stdout)


def test_cli_album_gain_in_two_processes_matches_single_and_jax(fixtures_dir, tmp_path,
                                                                capsys):
    files = _copies(fixtures_dir, tmp_path / "lib")
    argv = ["-a", "-n", "-o", "json", *files]
    ref = _single(argv)
    assert len(ref["files"]) == 4
    outs = _group(argv, 2)
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-2000:]
        doc = _doc(out)
        # Each process reports its round-robin slice ...
        assert [f["file"] for f in doc["files"]] == files[pid::2]
        assert doc["files"] == ref["files"][pid::2]
        # ... and the album block of the GLOBAL union, the single run's.
        assert doc["album"] == ref["album"], (pid, doc["album"])
    assert jcli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out)["album"]
    mine = ref["album"]
    assert mine["gain_steps"] == theirs["gain_steps"]
    assert abs(mine["loudness_db"] - theirs["loudness_db"]) <= 0.02 + 1e-9
    assert abs(mine["gain_db"] - theirs["gain_db"]) <= 0.02 + 1e-9
    np.testing.assert_allclose(mine["peak"], theirs["peak"], rtol=2e-4)


def test_an_empty_slice_joins_the_union_and_every_process_exits_0(fixtures_dir, tmp_path):
    files = _copies(fixtures_dir, tmp_path / "lib", NAMES[:2])
    argv = ["-a", "-n", "-o", "json", *files]
    ref = _single(argv)
    outs = _group(argv, 3)
    assert [rc for rc, _, _ in outs] == [0, 0, 0], [e[-800:] for _, _, e in outs]
    docs = [_doc(out) for _, out, _ in outs]
    assert [len(d["files"]) for d in docs] == [1, 1, 0]
    for d in docs:
        assert d["album"] == ref["album"]


def test_a_failure_on_one_slice_fails_the_album_on_every_process(fixtures_dir, tmp_path):
    files = _copies(fixtures_dir, tmp_path / "lib", NAMES[:3])
    bad = tmp_path / "lib" / "a3_corrupt.mp3"
    bad.write_bytes(b"corrupt" * 64)
    outs = _group(["-a", "-n", *files, str(bad)], 2)
    assert [rc for rc, _, _ in outs] == [1, 1], [e[-800:] for _, _, e in outs]
    assert "failed on another process's slice" in outs[0][2]
    assert "a3_corrupt.mp3" in outs[1][2] and "No valid MP3 frames" in outs[1][2]


UNION_PROG = ("import json, sys\n"
              "import numpy as np\n"
              "from mp3rgain_tpu_torch.parallel import multihost\n"
              "pid = multihost.process_index()\n"
              "peak = float('nan') if pid == int(sys.argv[1]) else 0.25 * (pid + 1)\n"
              "hist = np.zeros(12000, np.uint64)\n"
              "hist[2000 + pid] = 3\n"
              "h, p = multihost.album_union_global(hist, peak)\n"
              "print(json.dumps({'peak': repr(p), 'bins': np.nonzero(h)[0].tolist()}))\n")


@pytest.mark.parametrize("nan_pid", [0, 1])
def test_album_union_drops_a_nan_peak_like_pmax(nan_pid):
    """A process whose album peak is NaN, whichever rank it is: the union
    on every process is the other process's peak, as under the JAX
    package's pmax (which drops a NaN operand; gloo's MAX alone keeps or
    drops it by operand order)."""
    out = _group([str(nan_pid)], 2, prog=UNION_PROG)
    other = 0.25 * (2 - nan_pid)
    for rc, stdout, stderr in out:
        assert rc == 0, stderr[-2000:]
        assert json.loads(stdout.strip().splitlines()[-1]) == {"peak": repr(other),
                                                               "bins": [2000, 2001]}


def test_dryrun_multihost_2proc(capfd):
    dryrun.dryrun_multihost(2, device="cpu", timeout_s=TIMEOUT_S)
    out = capfd.readouterr().out
    assert out.count("album union bit-equal over gloo") == 2


def test_dryrun_multihost_raises_when_a_child_fails(monkeypatch):
    """A child that cannot import its entry point: the parent raises and
    leaves no process behind."""
    monkeypatch.setattr(dryrun.sys, "executable", "/bin/false")
    with pytest.raises(RuntimeError, match="failed in 2/2 processes"):
        dryrun.dryrun_multihost(2, device="cpu", timeout_s=60)


def test_process_slice_single_process(monkeypatch):
    """Outside a group process_slice is the identity and is_multihost is
    False; a group of one process is no group; inside one the slice is
    round-robin, all without torch.distributed."""
    for var in ("MP3RGAIN_COORDINATOR", "MP3RGAIN_NUM_PROCESSES", "MP3RGAIN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_config", None)
    items = ["a", "b", "c", "d", "e"]
    assert not multihost.is_multihost() and not multihost.maybe_initialize_from_env()
    assert multihost.process_slice(items) == items
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    multihost.initialize("localhost:1", 1, 0)
    assert not multihost.is_multihost()
    with pytest.raises(RuntimeError, match="not in a process group"):
        multihost.album_union_global(np.zeros(12000, np.uint64), 0.0)
    multihost.initialize("localhost:1", 3, 1)
    assert multihost.is_multihost()
    assert multihost.process_slice(items) == ["b", "e"]
    with pytest.raises(ValueError):
        multihost.initialize("localhost:1", 2, 2)
    assert [str(d) for d in multihost.local_devices()] in (
        ["cpu"], [f"cuda:{i}" for i in range(len(multihost.local_devices()))])


@pytest.mark.parametrize("pid", [0, 1])
def test_byte_surgery_under_the_coordinator_loads_no_torch(fixtures_dir, tmp_path, capsys,
                                                           pid):
    """`-g 2` in a fresh interpreter with the three variables set: no
    torch, no peer needed (no coordinator listens), only the slice
    rewritten, and rewritten as the JAX CLI rewrites those files."""
    files = _copies(fixtures_dir, tmp_path / "port")
    theirs = _copies(fixtures_dir, tmp_path / "jax")
    before = [open(f, "rb").read() for f in files]
    prog = ("import json, sys\n"
            "from mp3rgain_tpu_torch import cli\n"
            "rc = cli.main(['-g', '2', *sys.argv[1:]])\n"
            "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", prog, *files], cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT_S,
        env=_env(MP3RGAIN_COORDINATOR="localhost:1", MP3RGAIN_NUM_PROCESSES="2",
                 MP3RGAIN_PROCESS_ID=str(pid)))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "torch": False}
    assert "to 2 file(s)" in proc.stdout
    assert jcli.main(["-g", "2", *theirs[pid::2]]) == 0
    capsys.readouterr()
    for i, (f, t, b) in enumerate(zip(files, theirs, before)):
        got = open(f, "rb").read()
        assert got == open(t, "rb").read(), f
        assert (got != b) == (i % 2 == pid), f
