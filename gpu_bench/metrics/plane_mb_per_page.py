"""Device memory a page of the traced call allocates, in MB: the program's
counter ``compact.plane_bytes`` (each enqueued page's finder planes and
decode buffers, with its slot plan and signatures) over
``compact.pages``. A program without the counter has nothing to read."""

from gpu_bench import program_trace


def read(run):
    per_page = program_trace.per_page(
        run, lambda s: s.counters.get("compact.plane_bytes"))
    return None if per_page is None else per_page / 1e6
