"""Host ms per page in the occupancy plan in the traced call: the
program's span ``compact.occupancy`` (every call, halvings included) over
its counter ``compact.pages``."""

from gpu_bench import program_trace


def read(run):
    return program_trace.per_page(run,
                                  program_trace.span_ms("compact.occupancy"))
