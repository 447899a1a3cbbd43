"""Torch port: the GUI (mp3rgain_tpu_torch.gui) against the JAX package's.

The 18 cases of tests/test_gui.py, each run on the port's
AppState(device="cpu") and, on copies of the same lame-encoded fixtures,
on the JAX GUI: the same actions and the same scripted screen. After every
step the two hold the same rows: status, clip flag and gain steps equal,
volume and gains within 0.02 dB, peaks within rtol 2e-4; whatever either
wrote to its files is byte-identical; status messages are equal.
"""

import shutil

import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu import gui as jgui  # noqa: E402
from mp3rgain_tpu_torch import gui  # noqa: E402
from mp3rgain_tpu_torch import scan as scan_mod  # noqa: E402
from mp3rgain_tpu_torch.replaygain import REPLAYGAIN_REFERENCE_DB  # noqa: E402
from mp3rgain_tpu_torch.scan import BATCH_THRESHOLD  # noqa: E402

torch.set_num_threads(2)

PAIR = ("test_mono.mp3", "test_joint_stereo.mp3")


class Both:
    """The port's AppState and the JAX package's, each over its own copies
    of the same files."""

    def __init__(self, fixtures_dir, tmp_path, names, sources=PAIR):
        self.dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
        for d in self.dirs.values():
            d.mkdir()
            for i, name in enumerate(names):
                shutil.copy(fixtures_dir / sources[i % len(sources)], d / name)
        self.port = gui.AppState(device="cpu")
        self.jax = jgui.AppState()
        self.names = list(names)

    def each(self):
        return ((self.port, gui, self.dirs["port"]), (self.jax, jgui, self.dirs["jax"]))

    def add_all(self):
        for state, _, d in self.each():
            assert state.add_files([d / n for n in self.names]) == len(self.names)
        return self

    def do(self, action):
        """action(state, module, directory) on both; the two return values."""
        return [action(state, mod, d) for state, mod, d in self.each()]

    def ui(self, keys, **kw):
        """The same scripted keys through both ui_loops; the two screens."""
        screens = []
        for state, mod, _ in self.each():
            scr = FakeScreen([getattr(mod, k) if isinstance(k, str) and k.startswith("KEY_")
                              else k for k in keys], **kw)
            mod.ui_loop(state, scr)
            screens.append(scr)
        return screens

    def check(self):
        """The two states show the same table and wrote the same bytes."""
        p, j = self.port, self.jax
        assert [f.name for f in p.files] == [f.name for f in j.files]
        assert p.target_db == j.target_db
        for a, b in zip(p.files, j.files):
            assert (a.status, a.clipping) == (b.status, b.clipping), a.name
            assert (a.error is None) == (b.error is None), (a.name, a.error, b.error)
            for field in ("volume_db", "track_gain_db", "album_gain_db"):
                x, y = getattr(a, field), getattr(b, field)
                assert (x is None) == (y is None), (a.name, field)
                if x is not None:
                    assert abs(x - y) <= 0.02 + 1e-9, (a.name, field, x, y)
            assert (a.peak is None) == (b.peak is None)
            if a.peak is not None:
                assert a.peak == pytest.approx(b.peak, rel=2e-4)
        for ra, rb in zip(p.rows(), j.rows()):
            for col in ("file", "status", "clip", "gain_steps", "max_gain"):
                assert ra[col] == rb[col], (ra["file"], col)
        for a, b in zip(p.files, j.files):
            assert a.path.read_bytes() == b.path.read_bytes(), a.name
        return self

    def same_message(self):
        assert self.port.status_message == self.jax.status_message
        return self.port.status_message


@pytest.fixture()
def both(fixtures_dir, tmp_path):
    b = Both(fixtures_dir, tmp_path, PAIR)
    for state, _, d in b.each():
        state.add_folder(d)
    return b


class FakeScreen:
    """Scripted stand-in for a curses window (ui_loop's screen protocol)."""

    def __init__(self, keys, h=24, w=100):
        self.keys = [ord(k) if isinstance(k, str) else k for k in keys]
        self.h, self.w = h, w
        self.cells = []  # (y, x, text, attr) of the CURRENT frame
        self.frames = []  # all completed frames
        self.refreshes = 0

    def erase(self):
        if self.cells:
            self.frames.append(self.cells)
        self.cells = []

    def getmaxyx(self):
        return self.h, self.w

    def addnstr(self, y, x, s, n, attr=0):
        self.cells.append((y, x, s[:n], attr))

    def refresh(self):
        self.refreshes += 1

    def getch(self):
        return self.keys.pop(0) if self.keys else ord("q")

    def text(self):
        return "\n".join(c[2] for c in self.cells)


def test_add_files_dedup_and_filters(fixtures_dir, tmp_path):
    b = Both(fixtures_dir, tmp_path, ["a.mp3"], sources=("test_mono.mp3",))

    def add(state, _, d):
        (d / "._a.mp3").write_bytes(b"junk")  # resource fork: skipped
        (d / "notes.txt").write_text("x")  # non-audio: skipped
        return state.add_files([d / "a.mp3", d / "a.mp3", d / "._a.mp3", d / "notes.txt"])

    assert b.do(add) == [1, 1]
    assert len(b.port.files) == 1
    assert b.port.device == "cpu" and gui.AppState().device == "cuda"
    b.check()


def test_analyze_and_target_volume_math(both):
    both.do(lambda s, *_: s.analyze_tracks())
    both.check()
    state = both.port
    for f in state.files:
        assert f.status == "analyzed"
        assert f.track_gain_db is not None
        # volume = 89 - gain (app.rs display semantics)
        assert f.volume_db == pytest.approx(REPLAYGAIN_REFERENCE_DB - f.track_gain_db)
    # Raising the target by 6 dB raises the computed gain by 6 dB.
    f = state.files[0]
    g1 = state._entry_gain(f)
    both.do(lambda s, *_: setattr(s, "target_db", REPLAYGAIN_REFERENCE_DB + 6.0))
    assert state._entry_gain(f) == pytest.approx(g1 + 6.0)
    both.check()


def test_clip_prediction(both):
    both.do(lambda s, *_: s.analyze_tracks())

    def force(state, *_):
        # A target that guarantees predicted clipping: peak * 10^(gain/20) > 1.
        state.target_db = 100.0
        f = state.files[0]
        state._update_clipping(f)
        gain = state._entry_gain(f)
        assert f.clipping == (f.peak * 10.0 ** (gain / 20.0) > 1.0)
        return f.clipping

    got = both.do(force)
    assert got[0] == got[1]
    both.check()


def test_apply_and_undo_roundtrip(both):
    both.do(lambda s, *_: s.analyze_tracks())
    originals = {f.path: f.path.read_bytes() for f in both.port.files}
    assert both.do(lambda s, *_: s.apply_gain(use_album=False)) == [2, 2]
    both.check()  # the written bytes equal the JAX GUI's
    changed = [f for f in both.port.files if f.path.read_bytes() != originals[f.path]]
    assert changed  # at least the non-zero-gain files were modified
    assert both.do(lambda s, *_: s.undo_all()) == [len(changed)] * 2
    both.check()
    for f in both.port.files:
        assert f.path.read_bytes() == originals[f.path]


def test_album_analysis(both):
    both.do(lambda s, *_: s.analyze_album())
    both.check()
    gains = {f.album_gain_db for f in both.port.files}
    assert len(gains) == 1  # single shared album gain
    assert both.port.files[0].album_gain_db is not None
    assert both.do(lambda s, *_: s.apply_gain(use_album=True)) == [2, 2]
    both.check()


def test_rows_render(both):
    both.do(lambda s, *_: s.analyze_tracks())
    rows = list(both.port.rows())
    assert len(rows) == 2
    assert all(r["track_gain"] != "-" for r in rows)
    both.check()


def test_batch_analysis_matches_sequential(fixtures_dir, tmp_path):
    """>= scan.BATCH_THRESHOLD files route through scan_files and must
    produce the same per-file results as the sequential path."""
    names = [f"t{i:02d}.mp3" for i in range(BATCH_THRESHOLD)]
    b = Both(fixtures_dir, tmp_path, names).add_all()
    b.do(lambda s, *_: s.analyze_tracks())  # takes the _analyze_batch path
    assert all(f.status == "analyzed" for f in b.port.files)
    b.check()

    seq = gui.AppState(device="cpu")
    seq.add_files([f.path for f in b.port.files[:2]])
    seq.analyze_tracks()  # below threshold: per-file loop
    for bf, sf in zip(b.port.files[:2], seq.files):
        assert bf.track_gain_db == pytest.approx(sf.track_gain_db, abs=1e-9)
        assert bf.peak == pytest.approx(sf.peak, rel=1e-6)

    # Album over the same set: one shared album gain + clip update.
    b.do(lambda s, *_: s.analyze_album())
    gains = {f.album_gain_db for f in b.port.files}
    assert len(gains) == 1 and None not in gains
    b.check()


def test_ui_loop_renders_and_quits(both):
    port_scr, jax_scr = both.ui(["q"])
    out = port_scr.text()
    assert "mp3rgui (CUDA)" in out
    assert "test_mono.mp3" in out and "test_joint_stereo.mp3" in out
    assert port_scr.refreshes >= 1
    assert out == jax_scr.text().replace("mp3rgui (TPU)", "mp3rgui (CUDA)")


def test_ui_loop_analyze_apply_undo(both):
    originals = {f.path: f.path.read_bytes() for f in both.port.files}
    both.ui(["a", "g", "q"])
    assert both.same_message().startswith("Applied track gain")
    assert all(f.status == "applied" for f in both.port.files)
    changed = [f for f in both.port.files if f.path.read_bytes() != originals[f.path]]
    assert changed
    both.check()

    both.ui(["u", "q"])
    assert both.same_message() == f"Undid {len(changed)} file(s)"
    for f in both.port.files:
        assert f.path.read_bytes() == originals[f.path]
    both.check()


def test_ui_loop_target_and_selection_keys(both):
    t0 = both.port.target_db
    port_scr, jax_scr = both.ui(["+", "+", "-", "KEY_DOWN", "d", "q"])
    assert both.port.target_db == pytest.approx(t0 + 0.5)
    assert len(both.port.files) == 1  # KEY_DOWN then 'd' removed row 1
    assert both.port.files[0].name == "test_joint_stereo.mp3"
    # The selected row renders with the reverse attribute.
    for scr, mod in ((port_scr, gui), (jax_scr, jgui)):
        last = scr.frames[-1] if scr.frames else scr.cells
        assert len([c for c in last if c[3] == mod.A_REVERSE]) == 1
    both.check()


def test_batch_progress_is_incremental_and_scan_reused(fixtures_dir, tmp_path, monkeypatch):
    """Batch analysis reports per-file progress, analyze_tracks ->
    analyze_album does not decode the library again, and every scan runs
    on the AppState's device."""
    names = [f"t{i:02d}.mp3" for i in range(BATCH_THRESHOLD)]
    b = Both(fixtures_dir, tmp_path, names, sources=("test_mono.mp3",)).add_all()

    calls = []
    real_scan_files = scan_mod.scan_files

    def counting_scan_files(*a, **kw):
        calls.append(kw.get("device"))
        return real_scan_files(*a, **kw)

    monkeypatch.setattr(scan_mod, "scan_files", counting_scan_files)

    s = b.port
    seen = []
    s.analyze_tracks(progress_cb=lambda p, entry: seen.append((p, entry)))
    b.jax.analyze_tracks()
    assert calls == ["cpu"]
    # Incremental per-file updates, strictly increasing up to 1.0.
    progresses = [p for p, _ in seen]
    assert len(progresses) == BATCH_THRESHOLD
    assert progresses == sorted(progresses) and progresses[-1] == pytest.approx(1.0)
    assert all(e is not None for _, e in seen)
    b.check()

    b.do(lambda st, *_: st.analyze_album())  # must reuse the cached ScanResult
    assert calls == ["cpu"]
    assert all(f.album_gain_db is not None for f in s.files)
    b.check()

    b.do(lambda st, *_: st.apply_gain())  # invalidates the cache (files changed on disk)
    b.do(lambda st, *_: st.analyze_tracks())
    assert calls == ["cpu", "cpu"]
    b.check()


def test_batch_analysis_isolates_bad_files(fixtures_dir, tmp_path):
    names = [f"t{i:02d}.mp3" for i in range(BATCH_THRESHOLD - 1)]
    b = Both(fixtures_dir, tmp_path, names, sources=("test_mono.mp3",))

    def add(state, _, d):
        (d / "bad.mp3").write_bytes(b"\xff\xfb" + b"\x00" * 64)  # sync, no valid frames
        return state.add_files([d / n for n in [*names, "bad.mp3"]])

    assert b.do(add) == [BATCH_THRESHOLD] * 2
    b.do(lambda s, *_: s.analyze_tracks())
    by_name = {f.name: f for f in b.port.files}
    assert by_name["bad.mp3"].status == "error"
    assert by_name["bad.mp3"].error == {f.name: f for f in b.jax.files}["bad.mp3"].error
    good = [f for f in b.port.files if f.name != "bad.mp3"]
    assert all(f.status == "analyzed" for f in good)
    b.check()


def test_menu_bar_renders_and_navigates(both):
    """'m' opens File, arrows move between menus/items, Esc closes."""
    port_scr, jax_scr = both.ui(["m", "KEY_RIGHT", "KEY_DOWN", 27, "q"])
    # Menu titles are always on row 0.
    last = port_scr.frames[-1] if port_scr.frames else port_scr.cells
    row0 = " ".join(c[2] for c in last if c[0] == 0)
    for title in ("File", "Analysis", "Modify Gain", "Options", "Help"):
        assert title in row0
    # While Analysis was open, its dropdown items rendered.
    all_text = "\n".join("\n".join(c[2] for c in f) for f in port_scr.frames)
    assert "Track Analysis" in all_text and "Album Analysis" in all_text
    assert all_text == "\n".join("\n".join(c[2] for c in f) for f in jax_scr.frames).replace(
        "mp3rgui (TPU)", "mp3rgui (CUDA)")


def test_menu_analysis_and_apply_actions(both):
    """Analysis + Modify Gain menu items drive the same AppState paths as
    the key bindings."""
    # m -> right (Analysis) -> Enter (Track Analysis) -> quit
    both.ui(["m", "KEY_RIGHT", 10, "q"])
    assert all(f.status == "analyzed" for f in both.port.files)
    assert both.same_message() == "Track analysis done"
    both.check()

    originals = {f.path: f.path.read_bytes() for f in both.port.files}
    # m -> right x2 (Modify Gain) -> Enter (Apply Track Gain) -> quit
    both.ui(["m", "KEY_RIGHT", "KEY_RIGHT", 10, "q"])
    assert both.same_message().startswith("Applied track gain")
    assert all(f.status == "applied" for f in both.port.files)
    both.check()

    # Modify Gain -> down x3 -> Undo Gain Changes
    both.ui(["m", "KEY_RIGHT", "KEY_RIGHT", "KEY_DOWN", "KEY_DOWN", "KEY_DOWN", 10, "q"])
    assert both.same_message().startswith("Undid")
    for f in both.port.files:
        assert f.path.read_bytes() == originals[f.path]
    both.check()


def test_menu_options_target_and_help(both):
    t0 = both.port.target_db
    # Options -> Target +0.5
    both.ui(["m", "KEY_RIGHT", "KEY_RIGHT", "KEY_RIGHT", 10, "q"])
    assert both.port.target_db == pytest.approx(t0 + 0.5)
    # Options -> down x2 -> Reset
    both.ui(["m", "KEY_RIGHT", "KEY_RIGHT", "KEY_RIGHT", "KEY_DOWN", "KEY_DOWN", 10, "q"])
    assert both.port.target_db == REPLAYGAIN_REFERENCE_DB
    # Help -> About
    port_scr, _ = both.ui(["m", "KEY_LEFT", 10, "q"])
    assert "mp3rgui (CUDA)" in both.port.status_message
    assert "PyTorch" in both.port.status_message and "JAX" not in both.port.status_message
    # The target readout is visible on the menu bar row.
    last = port_scr.frames[-1] if port_scr.frames else port_scr.cells
    row0 = " ".join(c[2] for c in last if c[0] == 0)
    assert f"Target: {both.port.target_db:.1f} dB" in row0
    both.check()


def test_menu_constant_gain_prompt(both):
    """Apply Constant Gain... prompts for a dB value and applies it via
    the undo-tracked surgery."""
    originals = {f.path: f.path.read_bytes() for f in both.port.files}
    # Modify Gain -> down x2 -> Apply Constant Gain... -> "3.0" Enter
    keys = (["m", "KEY_RIGHT", "KEY_RIGHT", "KEY_DOWN", "KEY_DOWN", 10]
            + list("3.0") + [10, "q"])
    both.ui(keys)
    assert both.same_message() == "Applied constant gain to 2 file(s)"
    changed = [f for f in both.port.files if f.path.read_bytes() != originals[f.path]]
    assert len(changed) == 2  # 3.0 dB = 2 steps, both files modified
    both.check()
    assert both.do(lambda s, *_: s.undo_all()) == [2, 2]
    for f in both.port.files:
        assert f.path.read_bytes() == originals[f.path]


def test_menu_add_and_clear_files(both, fixtures_dir):
    n0 = len(both.port.files)
    for state, mod, d in both.each():
        extra = d / "extra.mp3"
        shutil.copy(fixtures_dir / "test_mono.mp3", extra)
        # File -> Add Files... -> type path -> Enter
        keys = ["m", 10] + [ord(ch) for ch in str(extra)] + [10, "q"]
        mod.ui_loop(state, FakeScreen(keys))
        assert len(state.files) == n0 + 1
    assert both.same_message() == "Added 1 file(s)"
    both.check()

    # File -> down x3 -> Clear File List
    both.ui(["m", "KEY_DOWN", "KEY_DOWN", "KEY_DOWN", 10, "q"])
    assert both.port.files == [] and both.jax.files == []

    # File -> down x4 -> Exit leaves the loop without consuming 'q'.
    for scr in both.ui(["m"] + ["KEY_DOWN"] * 4 + [10, "X"]):
        assert scr.keys == [ord("X")]


def test_status_panel_progress_bars(both):
    """The bottom panel shows dual File/Total bars and the file count,
    live-updated during analysis."""
    port_scr, jax_scr = both.ui(["a", "q"], h=24, w=100)
    for scr in (port_scr, jax_scr):
        all_frames = scr.frames + [scr.cells]
        bar_cells = [c for f in all_frames for c in f
                     if c[0] == 22 and c[2].startswith("File: [")]
        assert bar_cells, "status panel never rendered"
        assert any("Total: [############] 100%" in c[2] for c in bar_cells)
        count_cells = [c for f in all_frames for c in f if c[0] == 23]
        assert any("2 files" in c[2] for c in count_cells)
    both.check()
