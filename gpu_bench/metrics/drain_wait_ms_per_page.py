"""Host ms per page blocked in the drain in the traced call: the
program's span ``compact.drain.wait`` (each page's header copy, which
waits for the page's device work to end) over its counter
``compact.pages``."""

from gpu_bench import program_trace


def read(run):
    return program_trace.per_page(
        run, program_trace.span_ms("compact.drain.wait"))
