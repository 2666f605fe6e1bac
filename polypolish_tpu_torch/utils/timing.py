"""Wall-clock formatting (reference: misc.rs:195-201): ``h:mm:ss.us``."""

from __future__ import annotations


def format_duration(seconds: float) -> str:
    """Format an elapsed duration in seconds as h:mm:ss.microseconds.

    Truncates to whole microseconds (not rounds): the reference divides
    ``Duration::as_micros()`` (misc.rs:196-199), which discards the
    sub-microsecond remainder.  Rust's Duration stores integer
    nanoseconds, so we first snap the float to the nearest nanosecond
    (absorbing float representation error), then truncate nanos -> µs.
    """
    total_micros = round(seconds * 1_000_000_000) // 1000
    microseconds = total_micros % 1_000_000
    secs = total_micros // 1_000_000 % 60
    minutes = total_micros // 1_000_000 // 60 % 60
    hours = total_micros // 1_000_000 // 60 // 60
    return f"{hours}:{minutes:02}:{secs:02}.{microseconds:06}"
