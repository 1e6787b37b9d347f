"""Occupancy plans per page in the traced call: the program's counter
``compact.occupancy_calls`` (one per ``plan_query_occupancy`` call, each
halving of a page over ``qb_cap`` included) over ``compact.pages``."""

from gpu_bench import program_trace


def read(run):
    return program_trace.per_page(
        run, lambda s: s.counters.get("compact.occupancy_calls"))
