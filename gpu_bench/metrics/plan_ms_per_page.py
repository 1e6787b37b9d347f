"""Host ms per page enqueueing the slot plan in the traced call: the
program's span ``compact.plan`` (``plan_slots``' torch ops, no sync on
CUDA) over its counter ``compact.pages``."""

from gpu_bench import program_trace


def read(run):
    return program_trace.per_page(run, program_trace.span_ms("compact.plan"))
