"""Run metrics and batch-granular resume manifest.

The reference has neither (SURVEY.md §5): a crashed run leaves partial
output that blocks re-running (ConfigManager.py:172-175), and observability
is wall-clock prints. Here:

* :class:`Metrics` — per-stage wall time + counters, serialized to
  ``<output>.metrics.json`` after every stage (observability survives a
  crash); when ``[tpu] profile-dir`` is set it runs the whole run under a
  ``torch.profiler`` trace (one Chrome trace written there on close),
  which turns the tracer (:mod:`crackling_tpu_torch.trace`) on: each stage
  is a ``stage.<name>`` span, and the file gains the session's spans and
  counters under ``trace``.
* :class:`ResumeManifest` — records completed batches next to the output
  CSV. With ``[output] resume = True`` a re-run with the same config skips
  completed batches (candidate extraction is deterministic, so batch
  contents are reproducible) and appends where it left off.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from contextlib import contextmanager

from .. import trace


class Metrics:
    def __init__(self, path: str | None = None,
                 profile_dir: str | None = None):
        self.path = path
        self.profile_dir = profile_dir
        self.stages: dict[str, float] = {}
        self.counters: dict[str, int] = {}
        self._t0 = time.time()
        self._tracing = False

    def _ensure_trace(self):
        if self.profile_dir and not self._tracing:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._tracing = True

    def close(self):
        """Stop the profiler trace and write it under ``profile_dir``
        (no-op when profiling is off)."""
        if self._tracing:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.profile_dir, "trace.json"))
            self._tracing = False

    @contextmanager
    def stage(self, name: str):
        self._ensure_trace()
        t0 = time.time()
        try:
            with trace.span(f"stage.{name}"):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0
            self.flush()

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def to_dict(self):
        out = {
            "total_seconds": time.time() - self._t0,
            "stage_seconds": {k: round(v, 3) for k, v in self.stages.items()},
            "counters": self.counters,
        }
        if trace.active():
            out["trace"] = trace.session().to_dict()
        return out

    def flush(self):
        if self.path:
            try:
                with open(self.path, "w") as fp:
                    json.dump(self.to_dict(), fp, indent=1)
            except OSError:
                pass


def config_fingerprint(config_parser) -> str:
    """Stable hash of the effective configuration (for resume safety)."""
    items = []
    for section in sorted(config_parser.sections()):
        for key in sorted(config_parser[section]):
            items.append(f"{section}.{key}={config_parser[section][key]}")
    return hashlib.sha256("\n".join(items).encode()).hexdigest()[:16]


class ResumeManifest:
    def __init__(self, output_file: str, fingerprint: str):
        self.path = output_file + ".resume.json"
        self.output_file = output_file
        self.fingerprint = fingerprint
        self.completed = -1

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def load(self) -> int:
        """Number of already-completed batches (0 when no usable manifest).
        Also truncates the output CSV back to the byte offset recorded with
        the last completed batch, closing the crash window where a batch's
        rows were appended but the batch was never marked complete (those
        rows would otherwise be re-appended on resume)."""
        try:
            with open(self.path) as fp:
                d = json.load(fp)
            if d.get("fingerprint") == self.fingerprint:
                self.completed = int(d.get("completed_batches", 0))
                csv_bytes = d.get("csv_bytes")
                if csv_bytes is not None and os.path.exists(self.output_file):
                    if os.path.getsize(self.output_file) > csv_bytes:
                        with open(self.output_file, "r+b") as fp:
                            fp.truncate(int(csv_bytes))
                return self.completed
        except (OSError, ValueError):
            pass
        return 0

    def mark(self, completed_batches: int, total: int):
        self.completed = completed_batches
        try:
            csv_bytes = os.path.getsize(self.output_file)
        except OSError:
            csv_bytes = None
        with open(self.path, "w") as fp:
            json.dump({
                "fingerprint": self.fingerprint,
                "completed_batches": completed_batches,
                "total_batches": total,
                "csv_bytes": csv_bytes,
            }, fp)

    def finish(self):
        try:
            os.remove(self.path)
        except OSError:
            pass
