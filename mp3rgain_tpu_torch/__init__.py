"""mp3rgain_tpu_torch — the ReplayGain analysis path on PyTorch and CUDA.

A port of mp3rgain_tpu's MP3 analysis paths to PyTorch: the raw-bits
route, the main path (host light walk and lane plan → device lane pack →
Huffman decode → requantize + stereo → hybrid synthesis → overlap-add
and polyphase synthesis → equal-loudness IIR → loudness histogram), and
the host-decoded route, a reference the tests compare against (host full
decode → requantize + stereo → class-core GEMMs → polyphase GEMMs → the
same IIR and histogram); aac.py adds the AAC/M4A path. Six kernels are
written by hand for NVIDIA Hopper in CUDA C++: K0 the lane pack, which
builds the decode's lane-major input from the rows the host copied in
walk order (csrc/lane_pack.cu); K1 the Huffman decode, which writes each
spectrum straight into the row the next stage reads
(csrc/entropy_decode.cu); K2 the fused requantize + stereo pass
(csrc/requant_stereo.cu); K3 the split-bf16 class-core GEMM of the
host-decoded route (csrc/class_core_gemm.cu); K4 the hybrid synthesis,
alias butterflies and IMDCT by subband (csrc/hybrid_synthesis.cu); K5
the overlap-add and polyphase synthesis (csrc/overlap_polyphase.cu). No
GEMM is left in the raw-bits route's synthesis. The
host code it needs from mp3rgain_tpu (the native C++ front-end in
_native/, built with g++ on first use by native.py; the MP3 front-end,
the table builders, the filter coefficients, the buffer pool, the
crafted streams) is copied into this package, which imports neither
mp3rgain_tpu nor jax; tests/test_torch_host_copies.py holds the copies
equal to their originals.

Entry points: the mp3gain-compatible CLI (python -m
mp3rgain_tpu_torch.cli, a copy of the JAX package's, with its host
modules: bitstream, ape, id3v2, mp4meta, utils); scan.scan_files (library
scans with a resumable manifest) over parallel.runner.analyze_library;
the replaygain API; analysis.analyze_track_internal / analyze_album /
find_peak_amplitude; parallel.runner.Runner.analyze_unpacked_light and
.analyze_unpacked; and decode.synthesis.decode_file, each on the CUDA
card unless given device="cpu"; the curses GUI (python -m
mp3rgain_tpu_torch.gui, a copy too). Several GPUs in one process:
parallel.runner.RunnerGroup and analyze_library(runners=...); several
processes: parallel.multihost (a gloo group named by MP3RGAIN_COORDINATOR,
MP3RGAIN_NUM_PROCESSES and MP3RGAIN_PROCESS_ID), whose album union every
process of an album command joins; parallel.dryrun checks both. python -m
mp3rgain_tpu_torch.tools.hk_dotprobe times K3, and
mp3rgain_tpu_torch.tools.host_probe the scan's host side.

The package root re-exports the reference library's API from bitstream
and ape (analyze, apply_gain*, undo_gain, find_max_amplitude, the APEv2
tag functions and TAG_* keys), the same names as mp3rgain_tpu's root, and
parallel exports BatchResult, Runner, RunnerGroup and analyze_library.
Neither import loads torch.
"""

from .bitstream import (
    GAIN_STEP_DB,
    MAX_GAIN,
    MIN_GAIN,
    Channel,
    Mp3Analysis,
    Mp3Error,
    analyze,
    analyze_data,
    apply_gain,
    apply_gain_channel,
    apply_gain_channel_with_undo,
    apply_gain_db,
    apply_gain_with_undo,
    apply_gain_with_undo_wrap,
    apply_gain_wrap,
    db_to_steps,
    find_max_amplitude,
    is_mono,
    steps_to_db,
    undo_gain,
)
from .ape import (
    ApeTag,
    TAG_MP3GAIN_ALBUM_MINMAX,
    TAG_MP3GAIN_MINMAX,
    TAG_MP3GAIN_UNDO,
    TAG_REPLAYGAIN_ALBUM_GAIN,
    TAG_REPLAYGAIN_ALBUM_PEAK,
    TAG_REPLAYGAIN_TRACK_GAIN,
    TAG_REPLAYGAIN_TRACK_PEAK,
    delete_ape_tag,
    read_ape_tag,
    read_ape_tag_from_file,
    write_ape_tag,
)

__version__ = "0.1.0"

__all__ = [
    "GAIN_STEP_DB",
    "MAX_GAIN",
    "MIN_GAIN",
    "Channel",
    "Mp3Analysis",
    "Mp3Error",
    "ApeTag",
    "analyze",
    "analyze_data",
    "apply_gain",
    "apply_gain_channel",
    "apply_gain_channel_with_undo",
    "apply_gain_db",
    "apply_gain_with_undo",
    "apply_gain_with_undo_wrap",
    "apply_gain_wrap",
    "db_to_steps",
    "delete_ape_tag",
    "find_max_amplitude",
    "is_mono",
    "read_ape_tag",
    "read_ape_tag_from_file",
    "steps_to_db",
    "undo_gain",
    "write_ape_tag",
    "TAG_MP3GAIN_UNDO",
    "TAG_MP3GAIN_MINMAX",
    "TAG_MP3GAIN_ALBUM_MINMAX",
    "TAG_REPLAYGAIN_TRACK_GAIN",
    "TAG_REPLAYGAIN_TRACK_PEAK",
    "TAG_REPLAYGAIN_ALBUM_GAIN",
    "TAG_REPLAYGAIN_ALBUM_PEAK",
    "__version__",
]
