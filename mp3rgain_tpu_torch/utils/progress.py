"""Minimal terminal progress bar (equivalent of the reference's indicatif use:
shown for >= 5 files in text mode when not quiet; reference src/main.rs:546-577).

The torch port's copy of mp3rgain_tpu/utils/progress.py.
"""

from __future__ import annotations

import sys


class ProgressBar:
    def __init__(self, total: int, width: int = 40, stream=None):
        self.total = max(total, 1)
        self.pos = 0
        self.width = width
        self.msg = ""
        self.stream = stream or sys.stderr
        self.enabled = hasattr(self.stream, "isatty") and self.stream.isatty()

    def set_message(self, msg: str) -> None:
        self.msg = msg
        self._render()

    def inc(self, n: int = 1) -> None:
        self.pos += n
        self._render()

    def _render(self) -> None:
        if not self.enabled:
            return
        filled = self.width * self.pos // self.total
        bar = "=" * filled + ">" + "-" * max(0, self.width - filled - 1)
        self.stream.write(f"\r[{bar[: self.width]}] {self.pos}/{self.total} {self.msg}\x1b[K")
        self.stream.flush()

    def finish_and_clear(self) -> None:
        if self.enabled:
            self.stream.write("\r\x1b[K")
            self.stream.flush()
