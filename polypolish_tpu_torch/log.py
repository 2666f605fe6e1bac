"""Stderr narrative logging (reference: log.rs:16-36).

``section_header``: bold bright-yellow underlined title + dimmed timestamp.
``explanation``: dimmed, indented, wrapped to the stderr terminal width.
Colours are always emitted (the reference force-overrides colour support).
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import textwrap

_BOLD = "\033[1m"
_UNDERLINE = "\033[4m"
_BRIGHT_YELLOW = "\033[93m"
_DIM = "\033[2m"
_RESET = "\033[0m"

# Set to True to strip ANSI codes (used by tests and --no-color-ish envs).
PLAIN = bool(os.environ.get("POLYPOLISH_TPU_PLAIN_LOG"))

# When True, all narrative stderr output is suppressed (batch mode).
QUIET = False


class quiet:
    """Context manager that silences the narrative log."""

    def __enter__(self):
        global QUIET
        self._prev = QUIET
        QUIET = True
        return self

    def __exit__(self, *exc):
        global QUIET
        QUIET = self._prev
        return False


def _stderr_width(default: int = 80) -> int:
    try:
        if sys.stderr.isatty():
            return shutil.get_terminal_size((default, 24)).columns
    except Exception:
        pass
    return default


def section_header(text: str) -> None:
    if QUIET:
        return
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    date = f"({now})"
    print(file=sys.stderr)
    if PLAIN:
        print(f"{text} {date}", file=sys.stderr)
    else:
        print(
            f"{_BOLD}{_BRIGHT_YELLOW}{_UNDERLINE}{text}{_RESET} {_DIM}{date}{_RESET}",
            file=sys.stderr,
        )


def explanation(text: str) -> None:
    if QUIET:
        return
    term_width = _stderr_width()
    wrapped = textwrap.fill(f"    {text}", width=term_width)
    if PLAIN:
        print(wrapped, file=sys.stderr)
    else:
        print(f"{_DIM}{wrapped}{_RESET}", file=sys.stderr)
    print(file=sys.stderr)


def eprint(*args, **kwargs) -> None:
    if QUIET:
        return
    print(*args, file=sys.stderr, **kwargs)


def thousands(n: int) -> str:
    """Thousands-separated integer (reference uses num-format Locale::en)."""
    return f"{n:,}"
