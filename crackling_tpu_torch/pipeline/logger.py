"""stdout/stderr tee logger and timestamped printer.

Semantics of the reference Logger (/root/reference/src/crackling/Logger.py)
and Helpers.printer (Helpers.py:31-35).
"""

from __future__ import annotations

import sys
from datetime import datetime


class Logger:
    """Tee every write to the terminal and a log file."""

    def __init__(self, output_file: str):
        self.terminal = sys.stdout
        self.log = open(output_file, "w+")

    def __del__(self):
        try:
            self.log.close()
        except Exception:
            pass

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        # absl's atexit handler closes whatever sys.stderr points at;
        # close only the log file, never the real terminal stream
        try:
            self.log.close()
        except Exception:
            pass


def printer(string_format):
    """Timestamped progress line (reference Helpers.py:31-35)."""
    print(
        ">>> {}:\t{}\n".format(
            datetime.now().strftime("%Y-%m-%d %H:%M:%S:%f"), string_format
        )
    )
