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
- on AAC (an M4A, a raw ADTS stream, a two-track M4A with -i, an 88.2 kHz
  stream with its warning) -r, -a and -x give the JAX CLI's output: equal
  text but for numbers with a fraction, gain steps equal, loudness within
  0.02 dB, peaks within rtol 2e-4;
- a fresh interpreter running the byte surgery imports no torch, and
  `python -m mp3rgain_tpu_torch.cli` runs;
- in a multi-host group (MP3RGAIN_COORDINATOR and its companions) whose
  coordinator cannot be reached, an album command is refused with exit
  code 1 and the coordinator's address, not answered with a process-local
  album, while byte surgery works the process's slice
  (tests/test_torch_multihost.py runs real groups).
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


@pytest.fixture(scope="module")
def aac_files(tmp_path_factory):
    """Encoded here: a stereo M4A, a mono raw ADTS stream, an M4A with two
    audio tracks and an 88.2 kHz ADTS stream."""
    from mp3rgain_tpu.testing import avcodec, fixtures

    rng = np.random.default_rng(41)

    def pcm(seconds, sr, channels, freq):
        t = np.arange(int(sr * seconds)) / sr
        wave = (0.3 * np.sin(2 * np.pi * freq * t)
                + 0.04 * rng.standard_normal(len(t))).astype(np.float32)
        return wave if channels == 1 else np.stack([wave, np.roll(wave, 9)], axis=1)

    out = tmp_path_factory.mktemp("torch_cli_aac")
    files = {
        "a.m4a": fixtures.encode_m4a(pcm(1.2, 44100, 2, 523.0), 44100, bitrate=96000),
        "b.aac": avcodec.encode_adts(pcm(1.0, 22050, 1, 700.0), 22050, bitrate=48000),
        "two.m4a": fixtures.encode_m4a_multi(
            [(pcm(0.8, 44100, 2, 440.0), 44100), (pcm(1.0, 32000, 1, 880.0), 32000)],
            bitrate=96000),
        "hi.aac": avcodec.encode_adts(pcm(0.6, 88200, 2, 1000.0), 88200, bitrate=192000),
    }
    for name, data in files.items():
        (out / name).write_bytes(data)
    return out


def _aac_copies(aac_files, where, names) -> list[str]:
    where.mkdir()
    for name in names:
        shutil.copy(aac_files / name, where / name)
    return [str(where / name) for name in names]


def _assert_json_close(mine, theirs, n):
    assert len(mine["files"]) == len(theirs["files"]) == n
    for a, b in zip(mine["files"], theirs["files"]):
        assert sorted(a) == sorted(b)
        assert (a["file"], a["status"]) == (b["file"], b["status"])
        assert a.get("gain_applied_steps") == b.get("gain_applied_steps")
        assert a.get("warning") == b.get("warning")
        assert abs(a["loudness_db"] - b["loudness_db"]) <= 0.02 + 1e-9
        np.testing.assert_allclose(a["peak"], b["peak"], rtol=2e-4)
    assert mine["summary"] == theirs["summary"]


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
@pytest.mark.parametrize("mode", ["-r", "-a"])
def test_replaygain_commands_on_aac_match_jax(aac_files, fixtures_dir, tmp_path, capsys,
                                              mode, batch):
    """AAC beside MP3: tags only for AAC, and an album over both."""
    files = _aac_copies(aac_files, tmp_path / "lib", ["a.m4a", "b.aac", "two.m4a"])
    shutil.copy(fixtures_dir / "test_stereo.mp3", tmp_path / "lib" / "m.mp3")
    files.insert(1, str(tmp_path / "lib" / "m.mp3"))
    argv = [mode, batch, "--dry-run", "-o", "json", *files]
    mine = _json(cli.main, argv, capsys, device="cpu")
    theirs = _json(jcli.main, argv, capsys)
    _assert_json_close(mine, theirs, len(files))
    if mode == "-a":
        a, b = mine["album"], theirs["album"]
        assert a["gain_steps"] == b["gain_steps"]
        assert abs(a["loudness_db"] - b["loudness_db"]) <= 0.02 + 1e-9
        np.testing.assert_allclose(a["peak"], b["peak"], rtol=2e-4)


def test_replaygain_writes_the_same_aac_tags_as_jax(aac_files, tmp_path, capsys):
    """Not a dry run: an M4A gets tags only, through mp4meta; the text
    output equals the JAX CLI's but for numbers with a fraction, and the
    gain written agrees within 0.02 dB."""
    from mp3rgain_tpu import mp4meta as jmp4
    from mp3rgain_tpu_torch import mp4meta

    mine = _aac_copies(aac_files, tmp_path / "port", ["a.m4a"])
    theirs = _aac_copies(aac_files, tmp_path / "jax", ["a.m4a"])
    got = _run(cli.main, ["-r", "--no-batch", *mine], capsys, tmp_path / "port",
               device="cpu")
    want = _run(jcli.main, ["-r", "--no-batch", *theirs], capsys, tmp_path / "jax")
    assert got[0] == want[0] == 0 and got[2] == want[2]
    assert re.sub(r"[-+]?\d+\.\d+", "#", got[1]) == re.sub(r"[-+]?\d+\.\d+", "#", want[1])
    np.testing.assert_allclose(_numbers(got[1]), _numbers(want[1]), rtol=2e-4, atol=0.02)
    a, b = mp4meta.read_replaygain_tags(mine[0]), jmp4.read_replaygain_tags(theirs[0])
    assert a.track_gain is not None and "tags written" in got[1]
    assert abs(float(a.track_gain.split()[0]) - float(b.track_gain.split()[0])) <= 0.02 + 1e-9


@pytest.mark.parametrize("track", ["0", "1", "2"])
def test_track_index_on_a_two_track_m4a_matches_jax(aac_files, tmp_path, capsys, track):
    """-i picks the audio track; an index past the last one is the JAX
    CLI's per-file error."""
    files = _aac_copies(aac_files, tmp_path / "lib", ["two.m4a"])
    argv = ["-r", "-i", track, "--no-batch", "--dry-run", "-o", "json", *files]
    mine = _json(cli.main, argv, capsys, device="cpu")
    theirs = _json(jcli.main, argv, capsys)
    if track == "2":
        a, b = mine["files"][0], theirs["files"][0]
        assert a == b and a["status"] == "error" and "out of range" in a["error"]
    else:
        _assert_json_close(mine, theirs, 1)


def test_degenerate_rate_warning_on_aac_matches_jax(aac_files, tmp_path, capsys):
    files = _aac_copies(aac_files, tmp_path / "lib", ["hi.aac"])
    argv = ["-r", "--no-batch", "--dry-run", "-o", "json", *files]
    rc = cli.main(argv, device="cpu")
    out, err = capsys.readouterr()
    j_rc = jcli.main(argv)
    j_out, j_err = capsys.readouterr()
    assert rc == j_rc == 0 and err == j_err and "88200 Hz is unreliable" in err
    mine, theirs = json.loads(out), json.loads(j_out)
    assert mine["files"][0]["warning"] == theirs["files"][0]["warning"]
    assert mine["files"][0]["gain_applied_steps"] == theirs["files"][0]["gain_applied_steps"]


@pytest.mark.parametrize("fmt", [[], ["-o", "json"]])
def test_max_amplitude_on_aac_matches_jax(aac_files, tmp_path, capsys, fmt):
    """-x reads MP3 global gains first, so both CLIs refuse an AAC file the
    same way."""
    mine = _aac_copies(aac_files, tmp_path / "port", ["a.m4a", "b.aac"])
    theirs = _aac_copies(aac_files, tmp_path / "jax", ["a.m4a", "b.aac"])
    got = _run(cli.main, ["-x", *fmt, *mine], capsys, tmp_path / "port", device="cpu")
    want = _run(jcli.main, ["-x", *fmt, *theirs], capsys, tmp_path / "jax")
    assert got == want and (got[1] or got[2])


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
    """A group whose coordinator cannot be reached: the album command
    fails with the coordinator's address inside the time limit, with or
    without --no-batch, and leaves the files alone; -r and byte surgery
    need no peer and work this process's slice (files 1, 3, ...)."""
    from mp3rgain_tpu_torch.parallel import multihost

    files = _copies(fixtures_dir, tmp_path / "lib")
    before = [open(f, "rb").read() for f in files]
    monkeypatch.setattr(multihost, "_config", None)
    monkeypatch.setenv("MP3RGAIN_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MP3RGAIN_NUM_PROCESSES", "2")
    monkeypatch.setenv("MP3RGAIN_PROCESS_ID", "1")
    monkeypatch.setenv("MP3RGAIN_GROUP_TIMEOUT_S", "2")
    for argv in (["-a", *files], ["-a", "--no-batch", *files]):
        assert cli.main(argv, device="cpu") == 1
        err = capsys.readouterr().err
        assert "could not join its group at localhost:1" in err and "process 1 of 2" in err
    assert [open(f, "rb").read() for f in files] == before
    doc = _json(cli.main, ["-r", "--dry-run", "-o", "json", *files], capsys, device="cpu")
    assert [f["file"] for f in doc["files"]] == files[1::2]
    assert cli.main(["-g", "2", *files]) == 0
    out = capsys.readouterr().out
    assert "to 1 file(s)" in out and os.path.basename(files[1]) in out
    changed = [open(f, "rb").read() != b for f, b in zip(files, before)]
    assert changed == [False, True, False]


def test_analysis_without_a_card_fails_per_file(fixtures_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    files = _copies(fixtures_dir, tmp_path / "lib")
    doc = _json(cli.main, ["-r", "--no-batch", "--dry-run", "-o", "json", *files], capsys)
    assert all(f["status"] == "error" and "CUDA device is required" in f["error"]
               for f in doc["files"])
