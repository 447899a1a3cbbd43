"""mp3rgui-torch — interactive UI equivalent of the reference GUI.

The port's copy of mp3rgain_tpu/gui.py. It differs from it only in that
AppState carries a `device` ("cuda" by default; the tests pass "cpu") and
hands it to replaygain.analyze_track / analyze_album and to
scan.scan_files, that main() takes one, and that the title and the About
line name CUDA and PyTorch.

The reference ships a thin synchronous egui desktop app
(the reference's mp3rgui/): a file table with per-row volume/clipping
state, track/album analyze, apply, and a target-volume control. This
module reproduces that functionality as:

- AppState: the complete application logic (add files/folders with
  `._*` skipping and dedup, analyze, target-volume gain math
  gain = target − 89 + rg_gain (mp3rgui/src/app.rs:174), clip prediction
  peak * 10^(gain/20) > 1 (app.rs:242-245), apply/undo), fully headless
  and unit-tested;
- a curses terminal front-end (no desktop toolkit in this environment)
  with the same table columns and actions, a menu bar mirroring the
  reference's File/Analysis/Modify Gain/Options/Help structure
  (mp3rgui/src/ui/menu.rs), and a bottom status panel with dual
  File/Total progress bars + file count + status message
  (mp3rgui/src/ui/status.rs). Where the reference leaves TODOs
  (constant gain, undo from the menu), the menu items here are wired.

Run: mp3rgui-torch [files...]  (or python -m mp3rgain_tpu_torch.gui)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from . import mp4meta, replaygain
from .bitstream import GAIN_STEP_DB, Mp3Error, analyze, apply_gain_with_undo, db_to_steps, undo_gain
from .replaygain import REPLAYGAIN_REFERENCE_DB

AUDIO_EXTS = (".mp3", ".m4a", ".aac", ".mp4")


@dataclass
class FileEntry:
    """Per-row state (reference mp3rgui/src/app.rs FileEntry)."""

    path: Path
    status: str = "pending"
    volume_db: float | None = None  # measured loudness
    track_gain_db: float | None = None
    album_gain_db: float | None = None
    peak: float | None = None
    clipping: bool = False
    error: str | None = None

    @property
    def name(self) -> str:
        return self.path.name


@dataclass
class AppState:
    """Complete mp3rgui application logic, UI-independent."""

    files: list[FileEntry] = field(default_factory=list)
    target_db: float = REPLAYGAIN_REFERENCE_DB  # 75..100 slider in the reference
    status_message: str = ""
    progress: float = 0.0  # "Total" bar (reference total_progress)
    file_progress: float = 0.0  # "File" bar (reference file_progress)
    current_file: str = ""  # name shown next to the File bar
    device: str = "cuda"  # where the analysis runs
    # Last batch ScanResult + the path set it covered: analyze_tracks
    # followed by analyze_album must not decode the library twice.
    _last_scan: object = field(default=None, repr=False)
    _last_scan_paths: frozenset = field(default_factory=frozenset, repr=False)

    # -- file management (app.rs:65-147) ------------------------------------

    def add_files(self, paths) -> int:
        added = 0
        existing = {f.path for f in self.files}
        for p in map(Path, paths):
            if p.name.startswith("._"):  # macOS resource forks (app.rs:75)
                continue
            if p.suffix.lower() not in AUDIO_EXTS or p in existing:
                continue
            self.files.append(FileEntry(path=p))
            existing.add(p)
            added += 1
        return added

    def add_folder(self, folder, recursive: bool = True) -> int:
        """Add a folder's audio files; the reference menu offers both
        flat and recursive variants (menu.rs "Add Folder..." /
        "Add Folder (with subfolders)...")."""
        paths = []
        if recursive:
            for root, _, names in os.walk(folder):
                for n in sorted(names):
                    paths.append(Path(root) / n)
        else:
            try:
                paths = [Path(folder) / n for n in sorted(os.listdir(folder))]
            except OSError:
                return 0
        return self.add_files(paths)

    def remove_selected(self, indices) -> None:
        keep = [f for i, f in enumerate(self.files) if i not in set(indices)]
        self.files = keep

    def clear(self) -> None:
        self.files = []

    # -- analysis (app.rs:149-245) -------------------------------------------

    def _entry_gain(self, entry: FileEntry) -> float | None:
        """Gain to reach the target volume: target − 89 + rg_gain."""
        base = entry.album_gain_db if entry.album_gain_db is not None else entry.track_gain_db
        if base is None:
            return None
        return self.target_db - REPLAYGAIN_REFERENCE_DB + base

    def _update_clipping(self, entry: FileEntry) -> None:
        gain = self._entry_gain(entry)
        if gain is None or entry.peak is None:
            entry.clipping = False
            return
        entry.clipping = entry.peak * 10.0 ** (gain / 20.0) > 1.0

    def analyze_tracks(self, progress_cb=None) -> None:
        # Large file sets go through the batch mesh runner (same
        # threshold as the CLI, scan.BATCH_THRESHOLD); below it the
        # per-file loop keeps per-row progress snappy.
        from .scan import BATCH_THRESHOLD

        self.progress = self.file_progress = 0.0
        if len(self.files) >= BATCH_THRESHOLD:
            self._analyze_batch(album=False, progress_cb=progress_cb)
            return
        for i, entry in enumerate(self.files):
            self.current_file = entry.name
            self.file_progress = 0.0
            try:
                res = replaygain.analyze_track(entry.path, device=self.device)
                entry.volume_db = REPLAYGAIN_REFERENCE_DB - res.gain_db
                entry.track_gain_db = res.gain_db
                entry.peak = res.peak
                entry.status = "analyzed"
                entry.error = None
            except Exception as e:
                entry.status = "error"
                entry.error = str(e)
            self._update_clipping(entry)
            self.file_progress = 1.0
            self.progress = (i + 1) / max(len(self.files), 1)
            if progress_cb:
                progress_cb(self.progress, entry)

    def analyze_album(self, progress_cb=None) -> None:
        paths = [f.path for f in self.files]
        if not paths:
            return
        from .scan import BATCH_THRESHOLD

        self.progress = self.file_progress = 0.0
        if len(paths) >= BATCH_THRESHOLD:
            self._analyze_batch(album=True, progress_cb=progress_cb)
            return
        try:
            album = replaygain.analyze_album(paths, device=self.device)
        except Exception as e:
            self.status_message = f"Album analysis failed: {e}"
            return
        for entry, res in zip(self.files, album.tracks):
            entry.volume_db = REPLAYGAIN_REFERENCE_DB - res.gain_db
            entry.track_gain_db = res.gain_db
            entry.album_gain_db = album.album_gain_db
            entry.peak = res.peak
            entry.status = "analyzed"
            self._update_clipping(entry)
        self.progress = 1.0
        if progress_cb:
            progress_cb(1.0, None)

    def _analyze_batch(self, album: bool, progress_cb=None) -> None:
        """Batched analysis over the device mesh (scan.scan_files):
        bucketed batching, per-file fault isolation, identical results to
        the sequential path (same pipeline underneath). Progress advances
        per completed file (scan_files' callback), and the ScanResult is
        cached so analyze_tracks → analyze_album reuses it instead of
        decoding every file twice."""
        from .scan import album_union, scan_files

        paths = [f.path for f in self.files]
        path_set = frozenset(str(p) for p in paths)
        reused = (self._last_scan is not None
                  and self._last_scan_paths == path_set)
        if reused:
            scan = self._last_scan
        else:
            by_path = {str(f.path): f for f in self.files}
            done = [0]

            def _on_file(path):
                done[0] += 1
                entry = by_path.get(str(path))
                self.current_file = entry.name if entry else ""
                self.file_progress = 1.0
                self.progress = done[0] / max(len(paths), 1)
                if progress_cb:
                    progress_cb(self.progress, entry)

            scan = scan_files(paths, progress_cb=_on_file, device=self.device)
            self._last_scan = scan
            self._last_scan_paths = path_set
        album_gain = None
        if album:
            _, album_gain, _ = album_union(scan, paths)
        for i, entry in enumerate(self.files):
            res = scan.results.get(str(entry.path))
            if res is None or isinstance(res, Exception):
                entry.status = "error"
                entry.error = str(res) if res is not None else "not analyzed"
            else:
                entry.volume_db = REPLAYGAIN_REFERENCE_DB - res.gain_db
                entry.track_gain_db = res.gain_db
                if album and album_gain is not None:
                    entry.album_gain_db = album_gain
                entry.peak = res.peak
                entry.status = "analyzed"
                entry.error = None
            self._update_clipping(entry)
            self.progress = (i + 1) / max(len(self.files), 1)
            # Per-file progress was already streamed from scan_files'
            # callback during a fresh scan; only a cache-served pass
            # reports from this (instant) loop.
            if progress_cb and reused:
                progress_cb(self.progress, entry)

    # -- apply (app.rs:247-330) ----------------------------------------------

    def apply_gain(self, use_album: bool = False, progress_cb=None) -> int:
        self._last_scan = None  # files change on disk; cached scan is stale
        applied = 0
        for i, entry in enumerate(self.files):
            base = entry.album_gain_db if use_album else entry.track_gain_db
            if base is None:
                continue
            gain_db = self.target_db - REPLAYGAIN_REFERENCE_DB + base
            steps = db_to_steps(gain_db)
            try:
                if mp4meta.is_mp4_file(entry.path):
                    tags = mp4meta.ReplayGainTags()
                    tags.set_track(entry.track_gain_db or 0.0, entry.peak or 1.0)
                    if use_album and entry.album_gain_db is not None:
                        tags.set_album(entry.album_gain_db, entry.peak or 1.0)
                    mp4meta.write_replaygain_tags(entry.path, tags)
                elif steps != 0:
                    apply_gain_with_undo(entry.path, steps)
                entry.status = "applied"
                applied += 1
            except Exception as e:
                entry.status = "error"
                entry.error = str(e)
            self.progress = (i + 1) / max(len(self.files), 1)
            if progress_cb:
                progress_cb(self.progress, entry)
        return applied

    def apply_constant_gain(self, gain_db: float, progress_cb=None) -> int:
        """Apply a fixed dB gain to every MP3 in the list (the reference
        menu's "Apply Constant Gain..." — a TODO there, menu.rs:78-81;
        wired here via the same surgery as the CLI's -g)."""
        self._last_scan = None
        steps = db_to_steps(gain_db)
        applied = 0
        for i, entry in enumerate(self.files):
            if entry.path.suffix.lower() != ".mp3":
                continue
            try:
                if steps != 0:
                    apply_gain_with_undo(entry.path, steps)
                entry.status = "applied"
                entry.error = None
                applied += 1
            except Exception as e:
                entry.status = "error"
                entry.error = str(e)
            self.progress = (i + 1) / max(len(self.files), 1)
            if progress_cb:
                progress_cb(self.progress, entry)
        return applied

    def undo_all(self) -> int:
        self._last_scan = None
        count = 0
        for entry in self.files:
            try:
                if undo_gain(entry.path) > 0:
                    count += 1
                    entry.status = "undone"
            except Mp3Error:
                pass
        return count

    # -- table rendering data ------------------------------------------------

    def rows(self):
        """Table rows mirroring the reference's 9 columns (ui/table.rs)."""
        for entry in self.files:
            try:
                info = analyze(entry.path) if entry.path.suffix.lower() == ".mp3" else None
            except Mp3Error:
                info = None
            gain = self._entry_gain(entry)
            yield {
                "file": entry.name,
                "status": entry.status,
                "volume": f"{entry.volume_db:.1f}" if entry.volume_db is not None else "-",
                "clip": "CLIP" if entry.clipping else "",
                "track_gain": f"{entry.track_gain_db:+.1f}" if entry.track_gain_db is not None else "-",
                "album_gain": f"{entry.album_gain_db:+.1f}" if entry.album_gain_db is not None else "-",
                "gain_steps": str(db_to_steps(gain)) if gain is not None else "-",
                "max_gain": str(info.max_gain) if info else "-",
                "error": entry.error or "",
            }


# -----------------------------------------------------------------------------
# Curses front-end
# -----------------------------------------------------------------------------

_HELP = (
    "m:menu  a:analyze tracks  A:analyze album  g:apply track  "
    "G:apply album  u:undo  +/-:target  d:remove  q:quit"
)


# Key codes understood by ui_loop, independent of curses so the loop is
# drivable by tests with a fake screen (no TTY required).
KEY_UP = -10
KEY_DOWN = -11
KEY_LEFT = -12
KEY_RIGHT = -13
KEY_ENTER = 10
A_BOLD, A_UNDERLINE, A_REVERSE = 1, 2, 4

# Menu bar mirroring the reference's five menus (mp3rgui/src/ui/menu.rs:
# file_menu/analysis_menu/modify_menu/options_menu/help_menu). Each item
# maps to an action tag handled by _run_menu_action.
MENUS = (
    ("File", (
        ("Add Files...", "add_files"),
        ("Add Folder...", "add_folder"),
        ("Add Folder (with subfolders)...", "add_folder_rec"),
        ("Clear File List", "clear"),
        ("Exit", "exit"),
    )),
    ("Analysis", (
        ("Track Analysis", "analyze_tracks"),
        ("Album Analysis", "analyze_album"),
    )),
    ("Modify Gain", (
        ("Apply Track Gain", "apply_track"),
        ("Apply Album Gain", "apply_album"),
        ("Apply Constant Gain...", "apply_const"),
        ("Undo Gain Changes", "undo"),
    )),
    ("Options", (
        ("Target Volume +0.5 dB", "target_up"),
        ("Target Volume -0.5 dB", "target_down"),
        ("Reset Target Volume (89.0 dB)", "target_reset"),
    )),
    ("Help", (
        ("About mp3rgui", "about"),
        ("Key Bindings", "keys"),
    )),
)


def _bar(frac: float, width: int) -> str:
    frac = min(max(frac, 0.0), 1.0)
    return ("#" * round(frac * width)).ljust(width)


def _render_menubar(state: AppState, scr, w: int, menu) -> None:
    x = 1
    for mi, (title, _) in enumerate(MENUS):
        attr = A_REVERSE if menu is not None and menu[0] == mi else A_BOLD
        scr.addnstr(0, x, title, max(w - 1 - x, 1), attr)
        x += len(title) + 2
    target = f"Target: {state.target_db:.1f} dB"
    if x + len(target) < w:
        scr.addnstr(0, w - 1 - len(target), target, len(target), A_BOLD)


def _render_dropdown(scr, w: int, menu) -> None:
    mi, ii = menu
    x = 1 + sum(len(t) + 2 for t, _ in MENUS[:mi])
    for j, (label, _) in enumerate(MENUS[mi][1]):
        attr = A_REVERSE if j == ii else A_BOLD
        scr.addnstr(1 + j, x, f" {label} ", max(w - 1 - x, 1), attr)


def _render_status(state: AppState, scr) -> None:
    """Bottom status panel (reference mp3rgui/src/ui/status.rs): dual
    File/Total progress bars, then file count + status message."""
    h, w = scr.getmaxyx()
    fname = state.current_file[:20]
    line = (f"File: [{_bar(state.file_progress, 12)}] "
            f"{int(state.file_progress * 100):3d}%  "
            f"Total: [{_bar(state.progress, 12)}] "
            f"{int(state.progress * 100):3d}%"
            + (f"  {fname}" if fname else ""))
    scr.addnstr(h - 2, 0, line, w - 1)
    n = len(state.files)
    count = "No files loaded" if n == 0 else ("1 file" if n == 1 else f"{n} files")
    msg = count + (f" | {state.status_message}" if state.status_message else "")
    scr.addnstr(h - 1, 0, msg, w - 1)


def _prompt(state: AppState, scr, label: str) -> str | None:
    """Modal line editor on the status row (stands in for the
    reference's rfd file dialogs, which need a desktop). Enter accepts,
    Esc cancels, backspace edits."""
    buf = ""
    while True:
        h, w = scr.getmaxyx()
        scr.addnstr(h - 2, 0, (label + buf + "_").ljust(w - 1)[: w - 1],
                    w - 1, A_BOLD)
        scr.refresh()
        c = scr.getch()
        if c in (10, 13):
            return buf
        if c == 27:
            return None
        if c in (8, 127, 263):  # BS / DEL / curses KEY_BACKSPACE
            buf = buf[:-1]
        elif 32 <= c < 127:
            buf += chr(c)


def _analyze_with_progress(state: AppState, scr, album: bool) -> None:
    """Run analysis with the status panel live-updating per completed
    file (the reference streams file/total progress during batch
    analysis, status.rs:6-21)."""
    def cb(frac, entry):
        _render_status(state, scr)
        scr.refresh()

    state.status_message = "Analyzing album..." if album else "Analyzing tracks..."
    if album:
        state.analyze_album(progress_cb=cb)
        state.status_message = "Album analysis done"
    else:
        state.analyze_tracks(progress_cb=cb)
        state.status_message = "Track analysis done"


def _run_menu_action(state: AppState, scr, action: str) -> str | None:
    """Execute a menu item; returns "exit" to leave the UI loop."""
    from . import __version__

    if action == "exit":
        return "exit"
    if action == "add_files":
        txt = _prompt(state, scr, "Add file path: ")
        if txt:
            n = state.add_files([Path(txt.strip())])
            state.status_message = f"Added {n} file(s)"
    elif action in ("add_folder", "add_folder_rec"):
        txt = _prompt(state, scr, "Add folder path: ")
        if txt:
            n = state.add_folder(Path(txt.strip()),
                                 recursive=action == "add_folder_rec")
            state.status_message = f"Added {n} file(s)"
    elif action == "clear":
        state.clear()
        state.status_message = "File list cleared"
    elif action == "analyze_tracks":
        _analyze_with_progress(state, scr, album=False)
    elif action == "analyze_album":
        _analyze_with_progress(state, scr, album=True)
    elif action == "apply_track":
        n = state.apply_gain(use_album=False)
        state.status_message = f"Applied track gain to {n} file(s)"
    elif action == "apply_album":
        n = state.apply_gain(use_album=True)
        state.status_message = f"Applied album gain to {n} file(s)"
    elif action == "apply_const":
        txt = _prompt(state, scr, "Constant gain (dB): ")
        if txt:
            try:
                n = state.apply_constant_gain(float(txt.strip()))
                state.status_message = f"Applied constant gain to {n} file(s)"
            except ValueError:
                state.status_message = f"Not a number: {txt.strip()}"
    elif action == "undo":
        n = state.undo_all()
        state.status_message = f"Undid {n} file(s)"
    elif action == "target_up":
        state.target_db = min(100.0, state.target_db + 0.5)
    elif action == "target_down":
        state.target_db = max(75.0, state.target_db - 0.5)
    elif action == "target_reset":
        state.target_db = REPLAYGAIN_REFERENCE_DB
    elif action == "about":
        state.status_message = (
            f"mp3rgui (CUDA) {__version__} — lossless MP3/AAC volume "
            f"adjustment, ReplayGain analysis on PyTorch"
        )
    elif action == "keys":
        state.status_message = _HELP
    return None


def ui_loop(state: AppState, scr) -> None:
    """The interactive event loop against a curses-like screen object.

    `scr` needs: erase(), getmaxyx() -> (h, w), addnstr(y, x, s, n[,
    attr]), refresh(), getch() -> int. The real front-end passes a curses
    window (via _run_curses); tests pass a scripted fake. One full
    render + one key per iteration; returns when the user quits.

    Layout (reference mp3rgui/src/ui/): row 0 menu bar + target
    readout, row 1 title, row 2 key help, table from row 3, dropdown
    overlays the table while a menu is open, and the bottom two rows
    are the status panel (dual progress bars + file count/message).
    'm' opens the menu bar; arrows navigate, Enter runs, Esc closes.
    """
    selected = 0
    menu = None  # (menu_idx, item_idx) while a dropdown is open
    while True:
        scr.erase()
        h, w = scr.getmaxyx()
        _render_menubar(state, scr, w, menu)
        scr.addnstr(1, 0, f"mp3rgui (CUDA) — target {state.target_db:.1f} dB "
                          f"(each step = {GAIN_STEP_DB} dB)", w - 1, A_BOLD)
        scr.addnstr(2, 0, _HELP, w - 1)
        header = f"{'file':30s} {'status':9s} {'vol':>6s} {'clip':4s} {'trk':>6s} {'alb':>6s} {'steps':>5s}"
        scr.addnstr(3, 0, header, w - 1, A_UNDERLINE)
        for i, row in enumerate(state.rows()):
            if 4 + i >= h - 2:
                break
            line = (f"{row['file'][:30]:30s} {row['status']:9s} {row['volume']:>6s} "
                    f"{row['clip']:4s} {row['track_gain']:>6s} {row['album_gain']:>6s} "
                    f"{row['gain_steps']:>5s}")
            attr = A_REVERSE if i == selected and menu is None else 0
            scr.addnstr(4 + i, 0, line, w - 1, attr)
        if menu is not None:
            _render_dropdown(scr, w, menu)
        _render_status(state, scr)
        scr.refresh()

        c = scr.getch()
        if menu is not None:
            mi, ii = menu
            items = MENUS[mi][1]
            if c in (27, ord("m"), ord("q")):
                menu = None
            elif c == KEY_LEFT:
                menu = ((mi - 1) % len(MENUS), 0)
            elif c == KEY_RIGHT:
                menu = ((mi + 1) % len(MENUS), 0)
            elif c == KEY_UP:
                menu = (mi, max(0, ii - 1))
            elif c == KEY_DOWN:
                menu = (mi, min(len(items) - 1, ii + 1))
            elif c in (10, 13):
                menu = None
                if _run_menu_action(state, scr, items[ii][1]) == "exit":
                    break
                selected = max(0, min(selected, len(state.files) - 1))
            continue
        if c in (ord("q"), 27):
            break
        elif c == ord("m"):
            menu = (0, 0)
        elif c == ord("a"):
            _analyze_with_progress(state, scr, album=False)
        elif c == ord("A"):
            _analyze_with_progress(state, scr, album=True)
        elif c == ord("g"):
            n = state.apply_gain(use_album=False)
            state.status_message = f"Applied track gain to {n} file(s)"
        elif c == ord("G"):
            n = state.apply_gain(use_album=True)
            state.status_message = f"Applied album gain to {n} file(s)"
        elif c == ord("u"):
            n = state.undo_all()
            state.status_message = f"Undid {n} file(s)"
        elif c in (ord("+"), ord("=")):
            state.target_db = min(100.0, state.target_db + 0.5)
        elif c == ord("-"):
            state.target_db = max(75.0, state.target_db - 0.5)
        elif c == ord("d") and state.files:
            state.remove_selected([selected])
            selected = max(0, min(selected, len(state.files) - 1))
        elif c == KEY_UP:
            selected = max(0, selected - 1)
        elif c == KEY_DOWN:
            selected = min(len(state.files) - 1, selected + 1)


class _CursesScreen:  # pragma: no cover - needs a real TTY
    """Adapter mapping ui_loop's screen protocol onto a curses window."""

    def __init__(self, win, curses_mod):
        self._win = win
        self._curses = curses_mod
        self._attr = {
            A_BOLD: curses_mod.A_BOLD,
            A_UNDERLINE: curses_mod.A_UNDERLINE,
            A_REVERSE: curses_mod.A_REVERSE,
        }

    def erase(self):
        self._win.erase()

    def getmaxyx(self):
        return self._win.getmaxyx()

    def addnstr(self, y, x, s, n, attr=0):
        self._win.addnstr(y, x, s, n, self._attr.get(attr, 0))

    def refresh(self):
        self._win.refresh()

    def getch(self):
        c = self._win.getch()
        if c == self._curses.KEY_UP:
            return KEY_UP
        if c == self._curses.KEY_DOWN:
            return KEY_DOWN
        if c == self._curses.KEY_LEFT:
            return KEY_LEFT
        if c == self._curses.KEY_RIGHT:
            return KEY_RIGHT
        if c == self._curses.KEY_ENTER:
            return KEY_ENTER
        if c == 27:
            # Terminals whose terminfo lacks arrow-key capabilities
            # deliver CSI sequences raw (ESC [ A..D); parse them here so
            # menu navigation works everywhere. A lone ESC stays ESC.
            self._win.nodelay(True)
            try:
                c2 = self._win.getch()
                if c2 in (ord("["), ord("O")):
                    c3 = self._win.getch()
                    return {ord("A"): KEY_UP, ord("B"): KEY_DOWN,
                            ord("C"): KEY_RIGHT, ord("D"): KEY_LEFT}.get(c3, 27)
            finally:
                self._win.nodelay(False)
        return c


def _run_curses(state: AppState) -> None:  # pragma: no cover - interactive
    import curses

    def main(scr):
        curses.curs_set(0)
        ui_loop(state, _CursesScreen(scr, curses))

    curses.wrapper(main)


def main(argv=None, *, device: str = "cuda") -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    state = AppState(device=device)
    for a in args:
        p = Path(a)
        if p.is_dir():
            state.add_folder(p)
        else:
            state.add_files([p])
    try:
        _run_curses(state)
    except Exception as e:  # no TTY — print a plain table instead
        print(f"(no interactive terminal: {e})")
        state.analyze_tracks()
        for row in state.rows():
            print(row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
