"""Torch port: the mp3gain-compatible CLI (mp3rgain_tpu_torch.cli).

The port's CLI is a copy of the JAX package's. Both run here on copies of
the same lame-encoded fixtures:

- the byte-surgery commands (-g, -l, -u, -s c, -s d, info in text and
  JSON) give byte-identical output, exit codes and files;
- -x gives the same output but for the decoded peak, which is within
  rtol 2e-4 (each package decodes with its own pipeline);
- -r and -a, with --batch and --no-batch, --dry-run -o json, give equal
  gain steps and loudness within 0.02 dB (the port on the CPU, through
  main(..., device="cpu"));
- a fresh interpreter running the byte surgery imports no torch, and
  `python -m mp3rgain_tpu_torch.cli` runs;
- a multi-host group (MP3RGAIN_COORDINATOR) is refused with exit code 1.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu import cli as jcli  # noqa: E402
from mp3rgain_tpu_torch import cli  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["test_stereo.mp3", "test_mono.mp3", "test_mpeg2_22050.mp3"]


def _copies(fixtures_dir, where) -> list[str]:
    where.mkdir()
    out = []
    for name in NAMES:
        shutil.copy(fixtures_dir / name, where / name)
        out.append(str(where / name))
    return out


def _run(main, argv, capsys, where, **kw):
    """(exit code, stdout, stderr) with the directory's path written as
    <dir>."""
    rc = main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, out.replace(str(where), "<dir>"), err.replace(str(where), "<dir>")


SURGERY = {
    "apply": [["-g", "2"]],
    "apply channel": [["-l", "1", "-3"]],
    "undo": [["-g", "2"], ["-u"]],
    "check tags": [["-g", "-1"], ["-s", "c"]],
    "delete tags": [["-g", "2"], ["-s", "d"], ["-s", "c"]],
    "info text": [["-g", "1"], []],
    "info json": [["-g", "1"], ["-o", "json"]],
    "dry run": [["-g", "3", "--dry-run", "-o", "json"]],
}


@pytest.mark.parametrize("case", sorted(SURGERY))
def test_byte_surgery_is_byte_identical(fixtures_dir, tmp_path, capsys, case):
    mine = _copies(fixtures_dir, tmp_path / "port")
    theirs = _copies(fixtures_dir, tmp_path / "jax")
    for step in SURGERY[case]:
        got = _run(cli.main, step + mine, capsys, tmp_path / "port")
        want = _run(jcli.main, step + theirs, capsys, tmp_path / "jax")
        assert got == want, (case, step)
        assert got[1] or got[2], (case, step)
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read(), (case, a)


def _numbers(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", text)]


@pytest.mark.parametrize("fmt", [[], ["-o", "json"]])
def test_max_amplitude_matches_but_for_the_decoded_peak(fixtures_dir, tmp_path,
                                                        capsys, fmt):
    mine = _copies(fixtures_dir, tmp_path / "port")
    theirs = _copies(fixtures_dir, tmp_path / "jax")
    rc, out, err = _run(cli.main, ["-x", *fmt, *mine], capsys, tmp_path / "port",
                        device="cpu")
    j_rc, j_out, j_err = _run(jcli.main, ["-x", *fmt, *theirs], capsys,
                              tmp_path / "jax")
    assert (rc, err) == (j_rc, j_err) and rc == 0
    # Everything but the numbers with a fraction is identical ...
    assert re.sub(r"[-+]?\d+\.\d+", "#", out) == re.sub(r"[-+]?\d+\.\d+", "#", j_out)
    # ... and those (the peak as a PCM sample, the headroom) agree.
    got, want = _numbers(out), _numbers(j_out)
    assert len(got) == len(want) >= 2 * len(NAMES)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _json(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out)


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
@pytest.mark.parametrize("mode", ["-r", "-a"])
def test_replaygain_commands_match_jax(fixtures_dir, tmp_path, capsys, mode, batch):
    files = _copies(fixtures_dir, tmp_path / "lib")
    argv = [mode, batch, "--dry-run", "-o", "json", *files]
    mine = _json(cli.main, argv, capsys, device="cpu")
    theirs = _json(jcli.main, argv, capsys)
    assert len(mine["files"]) == len(theirs["files"]) == len(files)
    for a, b in zip(mine["files"], theirs["files"]):
        assert (a["file"], a["status"]) == (b["file"], b["status"]) == (a["file"], "dry_run")
        assert a["gain_applied_steps"] == b["gain_applied_steps"]
        assert abs(a["loudness_db"] - b["loudness_db"]) <= 0.02 + 1e-9
    assert mine["summary"] == theirs["summary"]
    if mode == "-a":
        a, b = mine["album"], theirs["album"]
        assert a["gain_steps"] == b["gain_steps"]
        assert abs(a["loudness_db"] - b["loudness_db"]) <= 0.02 + 1e-9
        np.testing.assert_allclose(a["peak"], b["peak"], rtol=2e-4)
    for f in files:  # a dry run leaves the files as they were
        assert open(f, "rb").read() == open(fixtures_dir / os.path.basename(f), "rb").read()


def test_batch_scan_writes_a_manifest_the_second_run_resumes(fixtures_dir, tmp_path,
                                                             capsys):
    files = _copies(fixtures_dir, tmp_path / "lib")
    manifest = str(tmp_path / "scan.json")
    argv = ["-r", "--batch", "--manifest", manifest, "--dry-run", *files]
    assert cli.main(argv, device="cpu") == 0
    first = capsys.readouterr().out
    assert cli.main(argv, device="cpu") == 0
    second = capsys.readouterr().out
    assert "resumed" not in first and f"{len(files)} resumed from manifest" in second
    assert len(json.load(open(manifest))) == len(files)


def test_byte_surgery_imports_no_torch(fixtures_dir, tmp_path):
    files = _copies(fixtures_dir, tmp_path / "lib")
    prog = (
        "import json, sys\n"
        "from mp3rgain_tpu_torch import cli\n"
        "rcs = [cli.main(a) for a in (['-g', '2', sys.argv[1]], ['-s', 'c', sys.argv[1]],\n"
        "       ['-u', sys.argv[1]], ['-o', 'json', sys.argv[1]], ['-s', 'd', sys.argv[1]])]\n"
        "print(json.dumps({'rcs': rcs, 'torch': 'torch' in sys.modules}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", prog, files[0]], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rcs": [0, 0, 0, 0, 0], "torch": False}
    proc = subprocess.run([sys.executable, "-m", "mp3rgain_tpu_torch.cli", "--version"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("mp3rgain"), proc.stderr


def test_multi_host_is_refused(fixtures_dir, tmp_path, capsys, monkeypatch):
    files = _copies(fixtures_dir, tmp_path / "lib")
    monkeypatch.setenv("MP3RGAIN_COORDINATOR", "localhost:1")
    for argv in (["-a", "--dry-run", *files], ["-r", "--batch", *files]):
        assert cli.main(argv, device="cpu") == 1
        assert "ROADMAP Queue 1 item 11" in capsys.readouterr().err


def test_analysis_without_a_card_fails_per_file(fixtures_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    files = _copies(fixtures_dir, tmp_path / "lib")
    doc = _json(cli.main, ["-r", "--no-batch", "--dry-run", "-o", "json", *files], capsys)
    assert all(f["status"] == "error" and "CUDA device is required" in f["error"]
               for f in doc["files"])
