"""Fail-fast error handling.

The reference (misc.rs:29-33) prints ``Error: <text>`` to stderr and exits
with status 1 for every invalid-input condition.  We mirror that contract
but raise a typed exception internally so library users (and tests) can
catch it; the CLI converts it to the stderr-message + exit(1) behaviour.
"""

from __future__ import annotations

import os
import sys


class PolypolishError(Exception):
    """Fatal input/validation error (reference: misc.rs quit_with_error)."""


def quit_with_error(text: str) -> None:
    """Raise a fatal error (reference: misc.rs:29-33).

    Inside the CLI this is rendered as a stderr message + exit(1); inside
    library/test use it propagates as `PolypolishError`.
    """
    raise PolypolishError(text)


def render_error_and_exit(err: PolypolishError) -> None:
    print(file=sys.stderr)
    print(f"Error: {err}", file=sys.stderr)
    sys.exit(1)


def check_if_file_exists(filename: str | os.PathLike) -> None:
    """Reference: misc.rs:21-26 (message uses Rust Debug quoting of paths)."""
    if not os.path.exists(filename):
        quit_with_error(f'"{filename}" file does not exist')
