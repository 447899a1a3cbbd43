"""Shared utilities: terminal color, progress reporting, the host buffer
pool (the torch port's copies of mp3rgain_tpu/utils)."""

from .term import Color, colorize, supports_color
from .progress import ProgressBar

__all__ = ["Color", "colorize", "supports_color", "ProgressBar"]
