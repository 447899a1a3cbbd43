"""ANSI terminal color helpers (equivalent of the reference's `colored` crate).

The torch port's copy of mp3rgain_tpu/utils/term.py."""

from __future__ import annotations

import os
import sys
from enum import Enum


class Color(Enum):
    RED = "31"
    GREEN = "32"
    YELLOW = "33"
    CYAN = "36"


def supports_color(stream=None) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    stream = stream or sys.stdout
    return hasattr(stream, "isatty") and stream.isatty()


def colorize(text: str, color: Color, bold: bool = False, stream=None) -> str:
    if not supports_color(stream):
        return text
    prefix = "\x1b[1m" if bold else ""
    return f"{prefix}\x1b[{color.value}m{text}\x1b[0m"
