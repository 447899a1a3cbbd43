"""mp3rgain-compatible command-line interface of the torch port.

    python -m mp3rgain_tpu_torch.cli [OPTIONS] <FILES>...   (or mp3rgain-torch)

The port's copy of mp3rgain_tpu/cli.py. It differs from it only where it
must: ReplayGain analysis (-r, -a, info with -o tsv, and -x's decoded
peak) runs through the port's replaygain and scan modules, on the CUDA
card (a caller of main() may pass device="cpu"; there is no device
flag); _require_replaygain names the torch pipeline; and in a multi-host
group (MP3RGAIN_COORDINATOR, parallel/multihost.py) a process with an
empty slice goes on into its command, so that an album command's union
finds every process there, and the processes refuse an album together
when a file failed on any of them. The byte-surgery commands (-g, -l, -u,
-s c, -s d, info in text or JSON) import no torch, under a coordinator
too; -x imports it for its decoded peak, as the JAX package's -x imports
jax.

Drop-in mp3gain replacement; flag grammar, dispatch priority, clipping
semantics, and output formats mirror the reference CLI (the reference
Rust mp3rgain, src/main.rs): hand-rolled parser with combined short flags
(-qp), attached values (-g2, -d4.5, -m2, -i1), `-o` with optional argument
(bare -o = TSV for mp3gain/beets compat, main.rs:273-297), warn-only unknown
flags (main.rs:421-423), and the command priority order of main.rs:436-540.

Batch-scan knobs are long-flag only (--batch, --no-batch, --manifest) to keep the mp3gain
short-flag namespace intact (SURVEY.md §5 config note).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

from . import mp4meta
from . import replaygain
from .bitstream import (
    Channel,
    GAIN_STEP_DB,
    Mp3Error,
    analyze,
    apply_gain,
    apply_gain_channel_with_undo,
    apply_gain_with_undo,
    apply_gain_with_undo_wrap,
    apply_gain_wrap,
    db_to_steps,
    find_max_amplitude,
    steps_to_db,
    undo_gain,
)
from .ape import (
    TAG_MP3GAIN_MINMAX,
    TAG_MP3GAIN_UNDO,
    TAG_REPLAYGAIN_ALBUM_GAIN,
    TAG_REPLAYGAIN_ALBUM_PEAK,
    TAG_REPLAYGAIN_TRACK_GAIN,
    TAG_REPLAYGAIN_TRACK_PEAK,
    delete_ape_tag,
    read_ape_tag_from_file,
)
from .replaygain import REPLAYGAIN_REFERENCE_DB
from .utils import Color, ProgressBar, colorize

VERSION = "0.1.0"
PROGRESS_THRESHOLD = 5


class OutputFormat(Enum):
    TEXT = "text"
    JSON = "json"
    TSV = "tsv"


class StoredTagMode(Enum):
    NONE = 0
    CHECK = 1
    DELETE = 2
    SKIP = 3
    RECALC = 4
    USE_ID3V2 = 5
    USE_APEV2 = 6


@dataclass
class Options:
    gain_steps: int | None = None
    gain_modifier_db: float = 0.0
    channel_gain: tuple[Channel, int] | None = None
    gain_modifier: int = 0

    undo: bool = False
    stored_tag_mode: StoredTagMode = StoredTagMode.NONE
    track_gain: bool = False
    album_gain: bool = False
    skip_album: bool = False
    max_amplitude_only: bool = False
    track_index: int | None = None

    preserve_timestamp: bool = False
    ignore_clipping: bool = False
    prevent_clipping: bool = False
    quiet: bool = False
    recursive: bool = False
    dry_run: bool = False
    output_format: OutputFormat = OutputFormat.TEXT
    wrap_gain: bool = False
    use_temp_file: bool = False
    assume_mpeg2: bool = False

    # Batch-scan knobs (long flags only; the mp3gain short-flag
    # namespace stays untouched, SURVEY.md §5).
    batch_mode: str = "auto"  # auto | always | never
    manifest: str | None = None
    # Reproduce the reference's symphonia F32 decoder ceiling: clamp
    # decoded peaks at 1.0 so TSV "Max Amplitude", -x output and the -k
    # cap match mp3rgain byte-for-byte on >1.0-peak files
    # (the reference's src/main.rs:610-616). Off by default — the port's
    # decoder reports the true unclipped peak (analysis.py).
    clip_peak_compat: bool = False
    # Where ReplayGain analysis runs: the CUDA card. Not a flag; a caller
    # of main() may pass device="cpu" (the tests do).
    device: str = "cuda"

    files: list[Path] = field(default_factory=list)


class CliError(SystemExit):
    pass


def _err(msg: str) -> None:
    print(f"{colorize('error', Color.RED, bold=True, stream=sys.stderr)}: {msg}", file=sys.stderr)


def _warn(msg: str) -> None:
    print(f"{colorize('warning', Color.YELLOW, bold=True, stream=sys.stderr)}: {msg}", file=sys.stderr)


_COMBINED_FLAG_CHARS = set("pqckuranRewxtf")


def parse_args(args: list[str]) -> Options:
    """Hand-rolled mp3gain-compatible parser (reference src/main.rs:183-434)."""
    opts = Options()
    if os.environ.get("MP3RGAIN_CLIP_PEAK_COMPAT", "") not in ("", "0"):
        opts.clip_peak_compat = True
    i = 0

    def need_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(args):
            _err(f"-{flag} requires an argument")
            raise SystemExit(1)
        return args[i]

    while i < len(args):
        arg = args[i]

        if arg == "--dry-run":
            opts.dry_run = True
            i += 1
            continue
        if arg == "--batch":
            opts.batch_mode = "always"
            i += 1
            continue
        if arg == "--no-batch":
            opts.batch_mode = "never"
            i += 1
            continue
        if arg == "--manifest":
            i += 1
            if i >= len(args):
                _err("--manifest requires an argument")
                raise SystemExit(1)
            opts.manifest = args[i]
            i += 1
            continue
        if arg == "--clip-peak-compat":
            opts.clip_peak_compat = True
            i += 1
            continue
        if arg == "--help":
            print_usage()
            raise SystemExit(0)
        if arg == "--version":
            print_version()
            raise SystemExit(0)

        if arg.startswith("-") and len(arg) > 1 and not arg.startswith("--"):
            flag = arg[1:]
            if flag == "g":
                v = need_value("g")
                try:
                    opts.gain_steps = int(v)
                except ValueError:
                    raise_invalid(f"invalid gain value: {v}")
            elif flag == "d":
                v = need_value("d")
                try:
                    opts.gain_modifier_db = float(v)
                except ValueError:
                    raise_invalid(f"invalid dB value: {v}")
            elif flag == "m":
                v = need_value("m")
                try:
                    opts.gain_modifier = int(v)
                except ValueError:
                    raise_invalid(f"invalid modifier value: {v}")
            elif flag == "s":
                v = need_value("s")
                if v == "c":
                    opts.stored_tag_mode = StoredTagMode.CHECK
                elif v == "d":
                    opts.stored_tag_mode = StoredTagMode.DELETE
                elif v == "s":
                    opts.stored_tag_mode = StoredTagMode.SKIP
                elif v == "r":
                    opts.stored_tag_mode = StoredTagMode.RECALC
                elif v == "i":
                    # Implemented for real (id3v2.py TXXX backend) where
                    # the reference warns and falls back to APEv2
                    # (src/main.rs:256-258).
                    opts.stored_tag_mode = StoredTagMode.USE_ID3V2
                elif v == "a":
                    opts.stored_tag_mode = StoredTagMode.USE_APEV2
                else:
                    _err(f"unknown -s mode '{v}', use c/d/s/r/i/a")
                    raise SystemExit(1)
            elif flag == "o":
                # Bare -o means TSV (mp3gain/beets compat, main.rs:273-297).
                nxt = args[i + 1].lower() if i + 1 < len(args) else ""
                if nxt in ("json", "text", "tsv", "db"):
                    i += 1
                    opts.output_format = {
                        "json": OutputFormat.JSON,
                        "text": OutputFormat.TEXT,
                        "tsv": OutputFormat.TSV,
                        "db": OutputFormat.TSV,
                    }[nxt]
                else:
                    opts.output_format = OutputFormat.TSV
            elif flag == "l":
                v = need_value("l")
                try:
                    channel_arg = int(v)
                except ValueError:
                    raise_invalid(f"invalid channel number: {v} (use 0 for left, 1 for right)")
                channel = Channel.from_index(channel_arg)
                if channel is None:
                    raise_invalid(f"invalid channel: {channel_arg} (use 0 for left, 1 for right)")
                g = need_value("l")
                try:
                    gain = int(g)
                except ValueError:
                    raise_invalid(f"invalid gain value: {g}")
                opts.channel_gain = (channel, gain)
            elif flag == "r":
                opts.track_gain = True
            elif flag == "a":
                opts.album_gain = True
            elif flag == "e":
                opts.skip_album = True
            elif flag == "x":
                opts.max_amplitude_only = True
            elif flag == "i":
                v = need_value("i")
                try:
                    opts.track_index = int(v)
                except ValueError:
                    raise_invalid(f"invalid track index: {v}")
            elif flag == "u":
                opts.undo = True
            elif flag == "p":
                opts.preserve_timestamp = True
            elif flag == "c":
                opts.ignore_clipping = True
            elif flag == "k":
                opts.prevent_clipping = True
            elif flag == "q":
                opts.quiet = True
            elif flag == "R":
                opts.recursive = True
            elif flag == "n":
                opts.dry_run = True
            elif flag == "w":
                opts.wrap_gain = True
            elif flag == "t":
                opts.use_temp_file = True
            elif flag == "f":
                opts.assume_mpeg2 = True
            elif flag in ("v", "-version"):
                print_version()
                raise SystemExit(0)
            elif flag in ("h", "-help"):
                print_usage()
                raise SystemExit(0)
            elif all(c in _COMBINED_FLAG_CHARS for c in flag):
                # Combined short flags like -qp, -kc (main.rs:369-390).
                for c in flag:
                    if c == "p":
                        opts.preserve_timestamp = True
                    elif c == "q":
                        opts.quiet = True
                    elif c == "c":
                        opts.ignore_clipping = True
                    elif c == "k":
                        opts.prevent_clipping = True
                    elif c == "u":
                        opts.undo = True
                    elif c == "r":
                        opts.track_gain = True
                    elif c == "a":
                        opts.album_gain = True
                    elif c == "n":
                        opts.dry_run = True
                    elif c == "R":
                        opts.recursive = True
                    elif c == "e":
                        opts.skip_album = True
                    elif c == "w":
                        opts.wrap_gain = True
                    elif c == "x":
                        opts.max_amplitude_only = True
                    elif c == "t":
                        opts.use_temp_file = True
                    elif c == "f":
                        opts.assume_mpeg2 = True
            elif flag.startswith("g"):
                v = flag[1:]
                try:
                    opts.gain_steps = int(v)
                except ValueError:
                    raise_invalid(f"invalid gain value: {v}")
            elif flag.startswith("d"):
                v = flag[1:]
                try:
                    opts.gain_modifier_db = float(v)
                except ValueError:
                    raise_invalid(f"invalid dB value: {v}")
            elif flag.startswith("m"):
                v = flag[1:]
                try:
                    opts.gain_modifier = int(v)
                except ValueError:
                    raise_invalid(f"invalid modifier value: {v}")
            elif flag.startswith("i"):
                v = flag[1:]
                try:
                    opts.track_index = int(v)
                except ValueError:
                    raise_invalid(f"invalid track index: {v}")
            else:
                _warn(f"unknown option: -{flag}")
        elif not arg.startswith("--"):
            opts.files.append(Path(arg))
        # Unknown long options are silently ignored (same as reference).

        i += 1

    return opts


def raise_invalid(msg: str) -> None:
    _err(msg)
    raise SystemExit(1)


def expand_files_recursive(paths: list[Path]) -> list[Path]:
    result: list[Path] = []
    for path in paths:
        if path.is_dir():
            _collect_audio_files(path, result)
        else:
            result.append(path)
    result.sort()
    return result


def _collect_audio_files(directory: Path, result: list[Path]) -> None:
    for entry in sorted(directory.iterdir()):
        if entry.is_dir():
            _collect_audio_files(entry, result)
        elif entry.suffix.lower() in (".mp3", ".m4a", ".aac", ".mp4"):
            result.append(entry)


# =============================================================================
# Output helpers
# =============================================================================

_JSON_FIELD_ORDER = [
    "file", "status", "frames", "mpeg_version", "channel_mode", "min_gain",
    "max_gain", "avg_gain", "headroom_steps", "headroom_db",
    "gain_applied_steps", "gain_applied_db", "loudness_db", "peak",
    "max_amplitude", "error", "warning", "dry_run",
]


# Sample rates whose published equal-loudness coefficient table row is
# numerically degenerate (loudness collapses to the histogram floor).
# The reference inherits the same 88200 Hz row and silently reports a
# bogus gain (NOTES.md round-1 #6); we keep the numeric parity but warn.
DEGENERATE_ANALYSIS_RATES = frozenset({88200})


def _degenerate_rate_warning(result, filename: str) -> str | None:
    """Warn (stderr) when analysis ran at a degenerate filter rate.

    Returns the warning string for the JSON `warning` field, or None."""
    sr = getattr(result, "sample_rate", None)
    if sr not in DEGENERATE_ANALYSIS_RATES:
        return None
    msg = (
        f"{filename}: ReplayGain analysis at {sr} Hz is unreliable — the "
        f"standard equal-loudness filter table is numerically degenerate "
        f"at this rate (all mp3gain-family implementations share this); "
        f"resample before trusting the gain"
    )
    _warn(msg)
    return f"analysis at {sr} Hz is degenerate; gain unreliable"


def _merge_warning(existing: str | None, new: str) -> str:
    return f"{existing}; {new}" if existing else new


def file_result(**kw) -> dict:
    """Ordered JSON file-result record with None fields omitted
    (reference JsonFileResult, src/main.rs:111-148)."""
    out = {}
    for k in _JSON_FIELD_ORDER:
        v = kw.get(k)
        if v is not None:
            out[k] = v
    return out


def json_summary(total: int, successful: int, failed: int, dry_run: bool) -> dict:
    out = {"total_files": total, "successful": successful, "failed": failed}
    if dry_run:
        out["dry_run"] = True
    return out


def print_json(files=None, album=None, summary=None) -> None:
    out = {}
    if files is not None:
        out["files"] = files
    if album is not None:
        out["album"] = album
    if summary is not None:
        out["summary"] = summary
    print(json.dumps(out, indent=2))


def get_filename(path: Path) -> str:
    return path.name or "unknown"


def create_progress_bar(total: int, opts: Options) -> ProgressBar | None:
    if opts.quiet or opts.output_format != OutputFormat.TEXT or total < PROGRESS_THRESHOLD:
        return None
    return ProgressBar(total)


def _pb_msg(pb, msg):
    if pb:
        pb.set_message(msg)


def _pb_inc(pb):
    if pb:
        pb.inc()


def _pb_finish(pb):
    if pb:
        pb.finish_and_clear()


def update_counters(result: dict, counters: list[int]) -> None:
    if result.get("status") == "success":
        counters[0] += 1
    elif result.get("status") == "error":
        counters[1] += 1


def print_dry_run_notice(opts: Options) -> None:
    if opts.dry_run and not opts.quiet and opts.output_format == OutputFormat.TEXT:
        print()
        print(colorize("No files were modified.", Color.YELLOW))


# =============================================================================
# Main dispatch
# =============================================================================


def main(argv: list[str] | None = None, *, device: str = "cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print_usage()
        return 0
    try:
        opts = parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    opts.device = device
    try:
        return run(opts)
    except SystemExit as e:
        return int(e.code or 0)


def run(opts: Options) -> int:
    if not opts.files:
        _err("no files specified")
        return 1

    if opts.recursive:
        opts.files = expand_files_recursive(opts.files)
        if not opts.files:
            _err("no audio files found (MP3/M4A)")
            return 1

    # Multi-host scans: when launched inside a process group
    # (MP3RGAIN_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID on every
    # host), each process works its round-robin slice of the list; album
    # analysis reduces over the group (scan.album_union) so all processes
    # apply identical album steps. The module imports no torch, which the
    # pure host byte-surgery commands (-g/-l/-u/...) must not pay for. A
    # process with an empty slice goes on: whether a command joins the
    # union depends on the options only, never on the slice.
    if os.environ.get("MP3RGAIN_COORDINATOR"):
        from .parallel import multihost

        if multihost.maybe_initialize_from_env():
            opts.files = multihost.process_slice(opts.files)

    if opts.assume_mpeg2 and not opts.quiet and opts.output_format == OutputFormat.TEXT:
        print(
            f"{colorize('note', Color.CYAN, stream=sys.stderr)}: -f (assume MPEG2) "
            "is accepted for compatibility but has no effect",
            file=sys.stderr,
        )

    # Dispatch priority mirrors reference src/main.rs:496-540.
    if opts.max_amplitude_only:
        return cmd_max_amplitude(opts.files, opts)
    if opts.stored_tag_mode == StoredTagMode.DELETE:
        return cmd_delete_tags(opts.files, opts)
    if opts.stored_tag_mode == StoredTagMode.CHECK:
        return cmd_check_tags(opts.files, opts)
    if opts.undo:
        return cmd_undo(opts.files, opts)
    if opts.album_gain and not opts.skip_album:
        return cmd_album_gain(opts.files, opts)
    if opts.track_gain or opts.skip_album:
        return cmd_track_gain(opts.files, opts)
    if opts.channel_gain is not None:
        channel, steps = opts.channel_gain
        return cmd_apply_channel(opts.files, channel, steps, opts)
    if opts.gain_steps is not None:
        return cmd_apply(opts.files, opts.gain_steps, opts)
    return cmd_info(opts.files, opts)


# =============================================================================
# Commands
# =============================================================================


def _clamp_peaks(opts: Options, result):
    """--clip-peak-compat: clamp decoded peaks at 1.0, reproducing the
    reference's symphonia F32 decoder ceiling (main.rs:610-616). Mutates
    ReplayGainResult/AlbumGainResult in place and returns it."""
    if not opts.clip_peak_compat or result is None:
        return result
    if hasattr(result, "album_peak"):
        result.album_peak = min(result.album_peak, 1.0)
        for t in result.tracks:
            _clamp_peaks(opts, t)
    elif hasattr(result, "peak"):
        result.peak = min(result.peak, 1.0)
    return result


def cmd_max_amplitude(files: list[Path], opts: Options) -> int:
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print(f"{colorize('mp3rgain', Color.GREEN, bold=True)} Finding maximum amplitude for {len(files)} file(s)")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []

    for f in files:
        filename = get_filename(f)
        _pb_msg(pb, filename)
        try:
            max_amp, max_gain, min_gain = find_max_amplitude(f, device=opts.device)
            if opts.clip_peak_compat:
                max_amp = min(max_amp, 1.0)
            max_pcm_sample = max_amp * 32768.0
            headroom_db = (-20.0 * _log10(max_amp)) if max_amp > 0 else float("inf")
            is_mp3 = f.suffix.lower() == ".mp3"
            may_clip = is_mp3 and max_amp >= 0.9999

            if opts.output_format == OutputFormat.TEXT:
                if not opts.quiet:
                    print(colorize(filename, Color.CYAN, bold=True))
                    print(f"  Max PCM sample: {max_pcm_sample:.6f}")
                    if may_clip:
                        print("  " + colorize("  (may be clipped - actual peak could be higher)", Color.YELLOW))
                    print(f"  Headroom:       {headroom_db:+.2f} dB")
                    print(f"  Max global_gain: {max_gain}")
                    print(f"  Min global_gain: {min_gain}")
                    print()
                else:
                    print(f"{filename}\t{max_pcm_sample:.6f}\t{headroom_db:.2f}")
            elif opts.output_format == OutputFormat.TSV:
                print(f"{filename}\t{max_pcm_sample:.6f}\t{headroom_db:.2f}\t{max_gain}\t{min_gain}")
            else:
                result = file_result(
                    file=str(f),
                    max_amplitude=max_pcm_sample,
                    headroom_db=headroom_db,
                    max_gain=max_gain,
                    min_gain=min_gain,
                    warning=("peak may be clipped - actual value could be higher" if may_clip else None),
                )
                json_results.append(result)
        except Exception as e:
            if opts.output_format == OutputFormat.JSON:
                json_results.append(file_result(file=str(f), status="error", error=str(e)))
            elif not opts.quiet:
                print(f"{colorize(filename, Color.RED, stream=sys.stderr)} - {e}", file=sys.stderr)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results)
    return 0


def cmd_delete_tags(files: list[Path], opts: Options) -> int:
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        verb = "Would delete" if opts.dry_run else "Deleting"
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} {verb} ReplayGain tags from {len(files)} file(s)")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []
    successful = failed = 0

    for f in files:
        filename = get_filename(f)
        _pb_msg(pb, filename)
        if opts.dry_run:
            if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                print(f"  {colorize('~', Color.CYAN)} [DRY RUN] {filename} (would delete tags)")
            json_results.append(file_result(file=str(f), status="dry_run", dry_run=True))
        else:
            original_mtime = _saved_mtime(f, opts)
            try:
                if mp4meta.is_mp4_file(f):
                    mp4meta.delete_replaygain_tags(f)
                else:
                    delete_ape_tag(f)
                _restore_mtime(f, original_mtime)
                if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                    print(f"  {colorize('v', Color.GREEN)} {filename} (tags deleted)")
                successful += 1
                json_results.append(file_result(file=str(f), status="success"))
            except Exception as e:
                if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                    print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
                failed += 1
                json_results.append(file_result(file=str(f), status="error", error=str(e)))
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, summary=json_summary(len(files), successful, failed, opts.dry_run))
    elif opts.dry_run and not opts.quiet:
        print()
        print(colorize("No files were modified.", Color.YELLOW))
    return 0


def cmd_check_tags(files: list[Path], opts: Options) -> int:
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print(f"{colorize('mp3rgain', Color.GREEN, bold=True)} Checking stored tag info for {len(files)} file(s)")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []

    for f in files:
        filename = get_filename(f)
        _pb_msg(pb, filename)
        try:
            # M4A ReplayGain lives in iTunes freeform tags, not APEv2.
            # (The reference reads only APE tags here — a known blind
            # spot; see docs/compatibility-report.md. MP3 output below is
            # unchanged.)
            if mp4meta.is_mp4_file(f):
                mtags = mp4meta.read_replaygain_tags(f)
                pairs = [
                    ("REPLAYGAIN_TRACK_GAIN", mtags.track_gain),
                    ("REPLAYGAIN_TRACK_PEAK", mtags.track_peak),
                    ("REPLAYGAIN_ALBUM_GAIN", mtags.album_gain),
                    ("REPLAYGAIN_ALBUM_PEAK", mtags.album_peak),
                ]
                if opts.output_format == OutputFormat.TEXT:
                    print(colorize(filename, Color.CYAN, bold=True))
                    if mtags.is_empty():
                        print("  (no ReplayGain tags found)")
                    else:
                        for key, val in pairs:
                            if val is not None:
                                print(f"  {key}: {val}")
                    print()
                elif opts.output_format == OutputFormat.TSV:
                    vals = [v if v is not None else "-" for _, v in pairs]
                    print("\t".join([filename, "-", "-"] + vals))
                else:
                    status = "no_tag" if mtags.is_empty() else "success"
                    json_results.append(file_result(file=str(f), status=status))
                _pb_inc(pb)
                continue
            tag = read_ape_tag_from_file(f)
            if tag is not None:
                undo = tag.get(TAG_MP3GAIN_UNDO)
                minmax = tag.get(TAG_MP3GAIN_MINMAX)
                track_gain = tag.get(TAG_REPLAYGAIN_TRACK_GAIN)
                track_peak = tag.get(TAG_REPLAYGAIN_TRACK_PEAK)
                album_gain = tag.get(TAG_REPLAYGAIN_ALBUM_GAIN)
                album_peak = tag.get(TAG_REPLAYGAIN_ALBUM_PEAK)
                if opts.output_format == OutputFormat.TEXT:
                    print(colorize(filename, Color.CYAN, bold=True))
                    if undo is not None:
                        print(f"  MP3GAIN_UNDO:         {undo}")
                    if minmax is not None:
                        print(f"  MP3GAIN_MINMAX:       {minmax}")
                    if track_gain is not None:
                        print(f"  REPLAYGAIN_TRACK_GAIN: {track_gain}")
                    if track_peak is not None:
                        print(f"  REPLAYGAIN_TRACK_PEAK: {track_peak}")
                    if album_gain is not None:
                        print(f"  REPLAYGAIN_ALBUM_GAIN: {album_gain}")
                    if album_peak is not None:
                        print(f"  REPLAYGAIN_ALBUM_PEAK: {album_peak}")
                    if undo is None and minmax is None and track_gain is None:
                        print("  (no mp3gain tags found)")
                    print()
                elif opts.output_format == OutputFormat.TSV:
                    vals = [v if v is not None else "-" for v in (undo, minmax, track_gain, track_peak, album_gain, album_peak)]
                    print("\t".join([filename] + vals))
                else:
                    json_results.append(file_result(file=str(f), status="success"))
            else:
                if opts.output_format == OutputFormat.TEXT:
                    print(colorize(filename, Color.CYAN, bold=True))
                    print("  (no APE tag found)")
                    print()
                elif opts.output_format == OutputFormat.TSV:
                    print(f"{filename}\t-\t-\t-\t-\t-\t-")
                else:
                    json_results.append(file_result(file=str(f), status="no_tag"))
        except Exception as e:
            if opts.output_format != OutputFormat.JSON:
                print(f"{colorize(filename, Color.RED, stream=sys.stderr)} - {e}", file=sys.stderr)
            else:
                json_results.append(file_result(file=str(f), status="error", error=str(e)))
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results)
    return 0


def cmd_apply(files: list[Path], steps: int, opts: Options) -> int:
    if steps == 0:
        if opts.output_format == OutputFormat.JSON:
            print_json(files=[], summary=json_summary(len(files), 0, 0, opts.dry_run))
        elif not opts.quiet:
            print(f"{colorize('info', Color.CYAN)}: gain is 0, nothing to do")
        return 0

    db_value = steps_to_db(steps)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        verb = "Would apply" if opts.dry_run else "Applying"
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} {verb} {steps} step(s) ({db_value:+.1f} dB) to {len(files)} file(s)")
        if opts.wrap_gain:
            print(f"  {colorize('!', Color.YELLOW)} Wrap mode enabled")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []
    counters = [0, 0]

    for f in files:
        filename = get_filename(f)
        _pb_msg(pb, filename)
        result = process_apply(f, steps, opts)
        update_counters(result, counters)
        if opts.output_format == OutputFormat.TSV:
            try:
                info = analyze(f)
                print(f"{filename}\t{steps}\t{db_value:.1f}\t{1.0:.6f}\t{info.max_gain}\t{info.min_gain}")
            except Mp3Error:
                pass
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, summary=json_summary(len(files), counters[0], counters[1], opts.dry_run))
    else:
        print_dry_run_notice(opts)
    return 0


def cmd_apply_channel(files: list[Path], channel: Channel, steps: int, opts: Options) -> int:
    if steps == 0:
        if opts.output_format == OutputFormat.JSON:
            print_json(files=[], summary=json_summary(len(files), 0, 0, opts.dry_run))
        elif not opts.quiet:
            print(f"{colorize('info', Color.CYAN)}: gain is 0, nothing to do")
        return 0

    db_value = steps_to_db(steps)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    channel_name = "left" if channel is Channel.LEFT else "right"
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        verb = "Would apply" if opts.dry_run else "Applying"
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} {verb} {steps} step(s) ({db_value:+.1f} dB) to {channel_name} channel of {len(files)} file(s)")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []
    counters = [0, 0]

    for f in files:
        filename = get_filename(f)
        _pb_msg(pb, filename)
        result = process_apply_channel(f, channel, steps, opts)
        update_counters(result, counters)
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, summary=json_summary(len(files), counters[0], counters[1], opts.dry_run))
    else:
        print_dry_run_notice(opts)
    return 0


def cmd_info(files: list[Path], opts: Options) -> int:
    if opts.output_format == OutputFormat.TSV:
        print("File\tMP3 gain\tdB gain\tMax Amplitude\tMax global_gain\tMin global_gain")

    pb = create_progress_bar(len(files), opts)
    json_results = []

    for f in files:
        _pb_msg(pb, get_filename(f))
        result = process_info(f, opts)
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results)
    return 0


def cmd_undo(files: list[Path], opts: Options) -> int:
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        verb = "Would undo" if opts.dry_run else "Undoing"
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} {verb} gain changes on {len(files)} file(s)")
        print()

    pb = create_progress_bar(len(files), opts)
    json_results = []
    counters = [0, 0]

    for f in files:
        _pb_msg(pb, get_filename(f))
        result = process_undo(f, opts)
        update_counters(result, counters)
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, summary=json_summary(len(files), counters[0], counters[1], opts.dry_run))
    else:
        print_dry_run_notice(opts)
    return 0


def _require_replaygain() -> None:
    if not replaygain.is_available():
        _err("ReplayGain analysis requires the torch analysis pipeline")
        print("  (torch and the mp3rgain_tpu_torch analysis modules must be importable; it runs on a CUDA card)", file=sys.stderr)
        raise SystemExit(1)


def _use_batch(files: list[Path], opts: Options) -> bool:
    from .parallel import multihost
    from .scan import BATCH_THRESHOLD

    if multihost.is_multihost():
        # Distributed runs must take the batch path, --no-batch or not:
        # only its album union performs the cross-process reduction
        # (scan.album_union); the non-batch analyze_album would compute
        # a process-local album gain.
        return True
    if opts.batch_mode == "never":
        return False
    if opts.batch_mode == "always":
        return True
    return len(files) >= BATCH_THRESHOLD


def _batch_scan(files: list[Path], opts: Options):
    """Batched analysis with the audio-hours/sec meter; returns ScanResult."""
    from . import scan as scan_mod

    result = scan_mod.scan_files(files, manifest_path=opts.manifest, device=opts.device)
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print(
            f"  {colorize('->', Color.CYAN)} analyzed "
            f"{result.audio_seconds / 3600.0:.2f} audio-hours in "
            f"{result.wall_seconds:.1f}s "
            f"({result.realtime_factor:.0f}x real-time, "
            f"{result.audio_hours_per_sec:.2f} audio-hours/sec"
            + (f", {result.resumed} resumed from manifest" if result.resumed else "")
            + ")"
        )
    return result


def cmd_track_gain(files: list[Path], opts: Options) -> int:
    _require_replaygain()
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        verb = "would apply" if opts.dry_run else "applying"
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} Analyzing and {verb} track gain to {len(files)} file(s)")
        print(f"  Target: {REPLAYGAIN_REFERENCE_DB} dB (ReplayGain 1.0)")
        if opts.gain_modifier != 0:
            print(f"  Gain modifier: {opts.gain_modifier:+} steps")
        print()

    scanned = _batch_scan(files, opts) if _use_batch(files, opts) else None

    pb = create_progress_bar(len(files), opts)
    json_results = []
    counters = [0, 0]

    for f in files:
        _pb_msg(pb, get_filename(f))
        pre = scanned.results.get(str(f)) if scanned else None
        result = process_track_gain(f, opts, precomputed=pre)
        update_counters(result, counters)
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, summary=json_summary(len(files), counters[0], counters[1], opts.dry_run))
    else:
        print_dry_run_notice(opts)
    return 0


def cmd_album_gain(files: list[Path], opts: Options) -> int:
    _require_replaygain()
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print(f"{dry_run_prefix}{colorize('mp3rgain', Color.GREEN, bold=True)} Analyzing album gain for {len(files)} file(s)")
        print(f"  Target: {REPLAYGAIN_REFERENCE_DB} dB (ReplayGain 1.0)")
        if opts.gain_modifier != 0:
            print(f"  Gain modifier: {opts.gain_modifier:+} steps")
        print()
        print(f"  {colorize('->', Color.CYAN)} Analyzing tracks...")

    try:
        if _use_batch(files, opts):
            from . import scan as scan_mod
            from .replaygain import AlbumGainResult

            scanned = _batch_scan(files, opts)
            failures = [
                (p, r) for p, r in scanned.results.items() if isinstance(r, Exception)
            ]
            from .parallel import multihost

            if multihost.is_multihost():
                # Every process learns of a failure on any slice before
                # the union, so that none waits there for one that left.
                if multihost.any_failed_global(bool(failures)) and not failures:
                    raise RuntimeError("a file failed on another process's slice")
            if failures:
                raise RuntimeError(f"{failures[0][0]}: {failures[0][1]}")
            loud, gain, peak = scan_mod.album_union(scanned, files)
            album_result = AlbumGainResult(
                tracks=[scanned.results[str(f)] for f in files],
                album_loudness_db=loud,
                album_gain_db=gain,
                album_peak=peak,
            )
        else:
            album_result = replaygain.analyze_album_with_index(
                files, opts.track_index, device=opts.device)
        _clamp_peaks(opts, album_result)
    except Exception as e:
        if opts.output_format == OutputFormat.JSON:
            print_json(summary=json_summary(len(files), 0, len(files), opts.dry_run))
        else:
            _err(f"Failed to analyze album: {e}")
        raise SystemExit(1)

    for f, tr in zip(files, album_result.tracks):
        _degenerate_rate_warning(tr, get_filename(f))

    modified_gain_steps = album_result.album_gain_steps() + opts.gain_modifier

    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print()
        print(f"  Album loudness: {album_result.album_loudness_db:.1f} dB")
        mod = (
            f" + {opts.gain_modifier} = {modified_gain_steps}"
            if opts.gain_modifier != 0
            else ""
        )
        print(f"  Album gain:     {album_result.album_gain_db:+.1f} dB ({album_result.album_gain_steps()} steps{mod})")
        print(f"  Album peak:     {album_result.album_peak:.4f}")
        print()

    album_json = {
        "loudness_db": album_result.album_loudness_db,
        "gain_db": album_result.album_gain_db,
        "gain_steps": modified_gain_steps,
        "peak": album_result.album_peak,
    }

    steps = modified_gain_steps
    if steps == 0:
        if opts.output_format == OutputFormat.JSON:
            json_results = [
                file_result(
                    file=str(f),
                    status="skipped",
                    loudness_db=t.loudness_db,
                    peak=t.peak,
                    gain_applied_steps=0,
                    gain_applied_db=0.0,
                )
                for f, t in zip(files, album_result.tracks)
            ]
            print_json(files=json_results, album=album_json, summary=json_summary(len(files), 0, 0, opts.dry_run))
        elif not opts.quiet:
            print(f"  {colorize('.', Color.CYAN)} No adjustment needed")
        return 0

    pb = create_progress_bar(len(files), opts)
    json_results = []
    counters = [0, 0]

    for f, track_result in zip(files, album_result.tracks):
        _pb_msg(pb, get_filename(f))
        album_info = (album_result.album_gain_db, album_result.album_peak)
        result = process_apply_replaygain(f, steps, track_result, opts, album_info)
        update_counters(result, counters)
        if opts.output_format == OutputFormat.JSON:
            json_results.append(result)
        _pb_inc(pb)

    _pb_finish(pb)
    if opts.output_format == OutputFormat.JSON:
        print_json(files=json_results, album=album_json, summary=json_summary(len(files), counters[0], counters[1], opts.dry_run))
    else:
        print_dry_run_notice(opts)
    return 0


# =============================================================================
# Per-file processors
# =============================================================================


def _log10(x: float) -> float:
    import math

    return math.log10(x)


def _saved_mtime(f: Path, opts: Options):
    if opts.preserve_timestamp and not opts.dry_run:
        try:
            return os.stat(f).st_mtime
        except OSError:
            return None
    return None


def _restore_mtime(f: Path, mtime) -> None:
    if mtime is not None:
        try:
            os.utime(f, (mtime, mtime))
        except OSError:
            pass


def apply_with_temp_file(f: Path, operation, opts: Options) -> int:
    """-t: copy→modify temp→rename, temp removed on error (main.rs:1458-1486)."""
    if not opts.use_temp_file:
        return operation(f)
    import shutil

    parent = f.parent if str(f.parent) else Path(".")
    temp_path = parent / f".mp3rgain_temp_{os.getpid()}.mp3"
    shutil.copy2(f, temp_path)
    try:
        frames = operation(temp_path)
    except Exception:
        try:
            temp_path.unlink()
        except OSError:
            pass
        raise
    os.replace(temp_path, f)
    return frames


def process_apply(f: Path, steps: int, opts: Options) -> dict:
    filename = get_filename(f)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    original_mtime = _saved_mtime(f, opts)

    # Clipping pre-check vs global_gain headroom (main.rs:1499-1546).
    actual_steps = steps
    warning_msg = None
    if steps > 0 and not opts.wrap_gain:
        try:
            info = analyze(f)
        except Mp3Error:
            info = None
        if info is not None and steps > info.headroom_steps:
            if opts.prevent_clipping:
                original_steps = steps
                actual_steps = info.headroom_steps
                if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                    print(
                        f"  {colorize('!', Color.YELLOW, stream=sys.stderr)} {dry_run_prefix}{filename} - gain reduced from {original_steps} to {actual_steps} steps to prevent clipping",
                        file=sys.stderr,
                    )
                warning_msg = f"gain reduced from {original_steps} to {actual_steps} steps to prevent clipping"
            elif not opts.ignore_clipping and not opts.quiet:
                if opts.output_format == OutputFormat.TEXT:
                    print(
                        f"  {colorize('!', Color.YELLOW, stream=sys.stderr)} {dry_run_prefix}{filename} - clipping warning: requested {steps} steps but only {info.headroom_steps} headroom",
                        file=sys.stderr,
                    )
                    print("      Use -c to ignore clipping warnings or -k to prevent clipping", file=sys.stderr)
                warning_msg = f"clipping warning: requested {steps} steps but only {info.headroom_steps} headroom"

    if opts.dry_run:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('~', Color.CYAN)} [DRY RUN] {filename} (would apply {actual_steps} steps)")
        return file_result(
            file=str(f), status="dry_run", gain_applied_steps=actual_steps,
            gain_applied_db=steps_to_db(actual_steps), warning=warning_msg, dry_run=True,
        )

    try:
        backend = _tag_backend(opts)
        if opts.stored_tag_mode == StoredTagMode.SKIP:
            if opts.wrap_gain:
                frames = apply_with_temp_file(f, lambda p: apply_gain_wrap(p, actual_steps), opts)
            else:
                frames = apply_with_temp_file(f, lambda p: apply_gain(p, actual_steps), opts)
        elif opts.wrap_gain:
            frames = apply_with_temp_file(f, lambda p: apply_gain_with_undo_wrap(p, actual_steps, backend=backend), opts)
        else:
            frames = apply_with_temp_file(f, lambda p: apply_gain_with_undo(p, actual_steps, backend=backend), opts)
        _restore_mtime(f, original_mtime)
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('v', Color.GREEN)} {filename} ({frames} frames)")
        return file_result(
            file=str(f), status="success", frames=frames,
            gain_applied_steps=actual_steps, gain_applied_db=steps_to_db(actual_steps),
            warning=warning_msg,
        )
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))


def _tag_backend(opts: Options) -> str:
    """Undo-bookkeeping store: APEv2 by default, ID3v2 TXXX under -s i."""
    return "id3" if opts.stored_tag_mode == StoredTagMode.USE_ID3V2 else "ape"


def process_apply_channel(f: Path, channel: Channel, steps: int, opts: Options) -> dict:
    filename = get_filename(f)
    channel_name = "left" if channel is Channel.LEFT else "right"
    original_mtime = _saved_mtime(f, opts)

    if opts.dry_run:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('~', Color.CYAN)} [DRY RUN] {filename} (would apply {steps} steps to {channel_name} channel)")
        return file_result(
            file=str(f), status="dry_run", gain_applied_steps=steps,
            gain_applied_db=steps_to_db(steps), dry_run=True,
        )

    try:
        frames = apply_gain_channel_with_undo(f, channel, steps,
                                              backend=_tag_backend(opts))
        _restore_mtime(f, original_mtime)
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('v', Color.GREEN)} {filename} ({frames} frames, {channel_name} channel)")
        return file_result(
            file=str(f), status="success", frames=frames,
            gain_applied_steps=steps, gain_applied_db=steps_to_db(steps),
        )
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))


def process_info(f: Path, opts: Options) -> dict:
    filename = get_filename(f)

    # TSV (mp3gain compatible) performs full ReplayGain analysis
    # (main.rs:1699-1746); peak scaled ×32768 because beets divides by 32768.
    if opts.output_format == OutputFormat.TSV and replaygain.is_available():
        try:
            rg = _clamp_peaks(opts, replaygain.analyze_track_with_index(
                f, opts.track_index, device=opts.device))
            try:
                max_amp, max_gain, min_gain = find_max_amplitude(f, device=opts.device)
            except Exception:
                max_amp, max_gain, min_gain = (1.0, 255, 0)
            if opts.clip_peak_compat:
                max_amp = min(max_amp, 1.0)
            gain_db = rg.gain_db + opts.gain_modifier_db
            gain_steps = db_to_steps(gain_db)
            max_amplitude_scaled = rg.peak * 32768.0
            print(f"{filename}\t{gain_steps}\t{gain_db:.6f}\t{max_amplitude_scaled:.6f}\t{max_gain}\t{min_gain}")
            return file_result(
                file=str(f), loudness_db=rg.loudness_db, gain_applied_db=gain_db,
                gain_applied_steps=gain_steps, peak=rg.peak, max_amplitude=max_amp,
                max_gain=max_gain, min_gain=min_gain,
            )
        except Exception as e:
            print(f"{colorize(filename, Color.RED, stream=sys.stderr)} - {e}", file=sys.stderr)
            return file_result(file=str(f), status="error", error=str(e))

    if mp4meta.is_mp4_file(f):
        if opts.output_format == OutputFormat.TEXT:
            if opts.quiet:
                print(f"{filename}\tM4A/AAC\t-\t-\t-\t-\t-")
            else:
                print(colorize(filename, Color.CYAN, bold=True))
                print("  Format:      M4A/AAC")
                print("  " + colorize("Note: Use -r or -a for ReplayGain analysis", Color.YELLOW))
                print()
        elif opts.output_format == OutputFormat.TSV:
            print(f"{filename}\t-\t-\t-\t-\t-")
        return file_result(file=str(f), status="info")

    try:
        info = analyze(f)
    except Mp3Error as e:
        if opts.output_format != OutputFormat.JSON:
            print(f"{colorize(filename, Color.RED, stream=sys.stderr)} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))

    if opts.output_format == OutputFormat.TEXT:
        if opts.quiet:
            print(f"{filename}\t{info.frame_count}\t{info.min_gain}\t{info.max_gain}\t{info.avg_gain:.1f}\t{info.headroom_steps}\t{info.headroom_db:.1f}")
        else:
            print(colorize(filename, Color.CYAN, bold=True))
            print(f"  Format:      {info.mpeg_version} Layer III, {info.channel_mode}")
            print(f"  Frames:      {info.frame_count}")
            print(f"  Gain range:  {info.min_gain} - {info.max_gain} (avg: {info.avg_gain:.1f})")
            print(f"  Headroom:    {colorize(str(info.headroom_steps), Color.GREEN)} steps ({info.headroom_db:+.1f} dB)")
            print()
    elif opts.output_format == OutputFormat.TSV:
        print(f"{filename}\t{info.headroom_steps}\t{info.headroom_db:.1f}\t{1.0:.6f}\t{info.max_gain}\t{info.min_gain}")

    return file_result(
        file=str(f), mpeg_version=info.mpeg_version, channel_mode=info.channel_mode,
        frames=info.frame_count, min_gain=info.min_gain, max_gain=info.max_gain,
        avg_gain=info.avg_gain, headroom_steps=info.headroom_steps,
        headroom_db=info.headroom_db,
    )


def process_undo(f: Path, opts: Options) -> dict:
    filename = get_filename(f)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    original_mtime = _saved_mtime(f, opts)

    if opts.dry_run:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('~', Color.CYAN)} [DRY RUN] {filename} (would undo)")
        return file_result(file=str(f), status="dry_run", dry_run=True)

    try:
        frames = undo_gain(f, backend=_tag_backend(opts))
        if frames == 0:
            if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                print(f"  {colorize('.', Color.CYAN)} {dry_run_prefix}{filename} (no changes to undo)")
            return file_result(file=str(f), status="skipped", frames=0)
        _restore_mtime(f, original_mtime)
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('v', Color.GREEN)} {filename} ({frames} frames restored)")
        return file_result(file=str(f), status="success", frames=frames)
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))


def process_track_gain(f: Path, opts: Options, precomputed=None) -> dict:
    filename = get_filename(f)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""

    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        print(f"  {colorize('->', Color.CYAN)} {dry_run_prefix}Analyzing {filename}...")

    try:
        if isinstance(precomputed, Exception):
            raise precomputed
        result = _clamp_peaks(opts, (
            precomputed
            if precomputed is not None
            else replaygain.analyze_track_with_index(f, opts.track_index, device=opts.device)
        ))
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))

    rate_warning = _degenerate_rate_warning(result, filename)
    base_steps = result.gain_steps()
    modified_steps = base_steps + opts.gain_modifier

    if opts.output_format == OutputFormat.TEXT and not opts.quiet:
        mod = (
            f" + {opts.gain_modifier} = {modified_steps}" if opts.gain_modifier != 0 else ""
        )
        print(f"      Loudness: {result.loudness_db:.1f} dB, Gain: {result.gain_db:+.1f} dB ({base_steps} steps{mod}), Peak: {result.peak:.4f}")

    if modified_steps == 0:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('.', Color.CYAN)} {filename} (no adjustment needed)")
        return file_result(
            file=str(f), status="skipped", loudness_db=result.loudness_db,
            peak=result.peak, gain_applied_steps=0, gain_applied_db=0.0,
            warning=rate_warning,
        )

    return process_apply_replaygain(f, modified_steps, result, opts, None,
                                    extra_warning=rate_warning)


def process_apply_replaygain(f: Path, steps: int, result, opts: Options, album_info,
                             extra_warning: str | None = None) -> dict:
    """Apply a ReplayGain-derived step count with decoded-peak clipping
    semantics (main.rs:2012-2170); AAC files get tags only (main.rs:2108-2119)."""
    filename = get_filename(f)
    dry_run_prefix = "[DRY RUN] " if opts.dry_run else ""
    original_mtime = _saved_mtime(f, opts)

    actual_steps = steps
    warning_msg = extra_warning
    if steps > 0 and not opts.wrap_gain:
        gain_linear = 10.0 ** (result.gain_db / 20.0)
        new_peak = result.peak * gain_linear
        if new_peak > 1.0:
            if opts.prevent_clipping:
                max_safe_db = -20.0 * _log10(result.peak)
                max_safe_steps = db_to_steps(max_safe_db)
                actual_steps = max(max_safe_steps, 0)
                if opts.output_format == OutputFormat.TEXT and not opts.quiet:
                    print(
                        f"  {colorize('!', Color.YELLOW, stream=sys.stderr)} {dry_run_prefix}{filename} - gain reduced from {steps} to {actual_steps} steps to prevent clipping (peak: {result.peak:.4f})",
                        file=sys.stderr,
                    )
                warning_msg = _merge_warning(warning_msg, f"gain reduced from {steps} to {actual_steps} steps to prevent clipping (peak: {result.peak:.4f})")
            elif not opts.ignore_clipping and not opts.quiet:
                if opts.output_format == OutputFormat.TEXT:
                    print(
                        f"  {colorize('!', Color.YELLOW, stream=sys.stderr)} {dry_run_prefix}{filename} - clipping warning: peak would be {new_peak:.2f} (>{1.0:.2f})",
                        file=sys.stderr,
                    )
                    print("      Use -c to ignore clipping warnings or -k to prevent clipping", file=sys.stderr)
                warning_msg = _merge_warning(warning_msg, f"clipping warning: peak would be {new_peak:.2f} (>1.00)")

    if opts.dry_run:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            format_info = " (tags only)" if result.file_type == "aac" else ""
            print(f"  {colorize('~', Color.CYAN)} [DRY RUN] {filename} (would apply {steps_to_db(actual_steps):+.1f} dB, {actual_steps} steps{format_info})")
        return file_result(
            file=str(f), status="dry_run", loudness_db=result.loudness_db,
            peak=result.peak, gain_applied_steps=actual_steps,
            gain_applied_db=steps_to_db(actual_steps), warning=warning_msg, dry_run=True,
        )

    if result.file_type == "aac":
        return _apply_replaygain_aac(f, result, opts, warning_msg, original_mtime, album_info)

    try:
        backend = _tag_backend(opts)
        if opts.wrap_gain:
            frames = apply_with_temp_file(f, lambda p: apply_gain_with_undo_wrap(p, actual_steps, backend=backend), opts)
        else:
            frames = apply_with_temp_file(f, lambda p: apply_gain_with_undo(p, actual_steps, backend=backend), opts)
        _restore_mtime(f, original_mtime)
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('v', Color.GREEN)} {filename} ({frames} frames, {steps_to_db(actual_steps):+.1f} dB)")
        return file_result(
            file=str(f), status="success", frames=frames,
            loudness_db=result.loudness_db, peak=result.peak,
            gain_applied_steps=actual_steps, gain_applied_db=steps_to_db(actual_steps),
            warning=warning_msg,
        )
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))


def _apply_replaygain_aac(f: Path, result, opts: Options, warning_msg, original_mtime, album_info) -> dict:
    filename = get_filename(f)
    tags = mp4meta.ReplayGainTags()
    tags.set_track(result.gain_db, result.peak)
    if album_info is not None:
        album_gain_db, album_peak = album_info
        tags.set_album(album_gain_db, album_peak)
    try:
        mp4meta.write_replaygain_tags(f, tags)
        _restore_mtime(f, original_mtime)
        tag_type = "track+album tags" if album_info is not None else "tags"
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('v', Color.GREEN)} {filename} ({tag_type} written, {result.gain_db:+.1f} dB)")
        return file_result(
            file=str(f), status="success", loudness_db=result.loudness_db,
            peak=result.peak, gain_applied_steps=result.gain_steps(),
            gain_applied_db=result.gain_db, warning=warning_msg,
        )
    except Exception as e:
        if opts.output_format == OutputFormat.TEXT and not opts.quiet:
            print(f"  {colorize('x', Color.RED, stream=sys.stderr)} {filename} - {e}", file=sys.stderr)
        return file_result(file=str(f), status="error", error=str(e))


# =============================================================================
# Help / Version
# =============================================================================


def print_version() -> None:
    print(f"mp3rgain version {VERSION}")
    print("A GPU-native mp3gain replacement (PyTorch/CUDA port of mp3rgain_tpu)")
    print()
    print(f"Each gain step = {GAIN_STEP_DB} dB")


def print_usage() -> None:
    g = lambda s: colorize(s, Color.GREEN, bold=True)  # noqa: E731
    c = lambda s: colorize(s, Color.CYAN, bold=True)  # noqa: E731
    print(f"{g('mp3rgain')} version {VERSION}")
    print("Lossless MP3 volume adjustment - a GPU-native mp3gain replacement (PyTorch/CUDA)")
    print()
    print(c("USAGE:"))
    print("    mp3rgain [OPTIONS] <FILES>...")
    print()
    print(c("OPTIONS:"))
    print(f"    -g <i>      Apply gain of i steps (each step = {GAIN_STEP_DB} dB)")
    print("    -d <n>      Apply gain of n dB (rounded to nearest step)")
    print("    -l <c> <g>  Apply gain to left (0) or right (1) channel only")
    print("    -m <i>      Modify suggested gain by integer i")
    print("    -r          Apply Track gain (ReplayGain analysis)")
    print("    -a          Apply Album gain (ReplayGain analysis)")
    print("    -e          Skip album analysis (even with multiple files)")
    print("    -i <n>      Specify which audio track to process (default: 0)")
    print("    -u          Undo gain changes (restore from APEv2 tag)")
    print("    -x          Only find max amplitude of file")
    print("    -s <mode>   Stored tag handling:")
    print("                  c = check/show stored tag info")
    print("                  d = delete stored tag info")
    print("                  s = skip (ignore) stored tag info")
    print("                  r = force recalculation")
    print("                  i = use ID3v2 tags (TXXX frames)")
    print("                  a = use APEv2 tags (default)")
    print("    -p          Preserve original file timestamp")
    print("    -c          Ignore clipping warnings")
    print("    -k          Prevent clipping (automatically limit gain)")
    print("    -w          Wrap gain values (instead of clamping)")
    print("    -t          Use temp file for writing (safer, required for some ops)")
    print("    -f          Assume MPEG 2 Layer III (compatibility, no effect)")
    print("    -q          Quiet mode (less output)")
    print("    -R          Process directories recursively")
    print("    -n          Dry-run mode (show what would be done)")
    print("    --dry-run   Same as -n")
    print("    --clip-peak-compat  Clamp decoded peaks at 1.0 (match mp3rgain's decoder)")
    print("    -o <fmt>    Output format: 'text' (default), 'json', or 'tsv'")
    print("    -v          Show version")
    print("    -h          Show this help")
    print()
    print(c("EXAMPLES:"))
    print("    mp3rgain song.mp3              Show file info")
    print("    mp3rgain -g 2 song.mp3         Apply +2 steps (+3.0 dB)")
    print("    mp3rgain -r song.mp3           Analyze and apply track gain")
    print("    mp3rgain -a *.mp3              Analyze and apply album gain")
    print("    mp3rgain -u song.mp3           Undo previous gain changes")
    print("    mp3rgain -s c *.mp3            Check stored tag info")
    print("    mp3rgain -o json song.mp3      Output in JSON format")
    print()
    print(c("NOTES:"))
    print(f"    - Each gain step = {GAIN_STEP_DB} dB (fixed by MP3 specification)")
    print("    - Changes are lossless and reversible")
    print("    - Gain changes are stored in APEv2 tags for undo support")
    print("    - Progress bar shown automatically for 5+ files")
    if replaygain.is_available():
        print(f"    - ReplayGain analysis is {colorize('enabled', Color.GREEN)} (target: {REPLAYGAIN_REFERENCE_DB} dB)")
    else:
        print()
        print(colorize("REPLAYGAIN:", Color.YELLOW, bold=True))
        print("    -r and -a options require the torch analysis pipeline (torch, a CUDA card)")


if __name__ == "__main__":
    sys.exit(main())
