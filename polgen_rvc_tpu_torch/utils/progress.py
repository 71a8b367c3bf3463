"""Staged progress reporting, decoupled from any UI: a copy of the JAX
package's utils/progress.py."""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional


class ProgressReporter:
    """Callable sink for (fraction, message) progress events.

    The default sink prints to stderr; a UI or CLI installs its own."""

    def __init__(self, sink: Optional[Callable[[float, str], None]] = None,
                 quiet: bool = False):
        self._sink = sink
        self._quiet = quiet
        self._t0 = time.monotonic()

    def __call__(self, fraction: float, message: str):
        if self._sink is not None:
            self._sink(fraction, message)
        elif not self._quiet:
            dt = time.monotonic() - self._t0
            print(f"[{fraction:5.0%} {dt:6.1f}s] {message}", file=sys.stderr)


NULL_PROGRESS = ProgressReporter(quiet=True)
