"""The benchmark's frozen bound arithmetic gives chip_smoke.py's numbers,
and the traced window's reading is sound on a made-up timeline."""

import numpy as np
import pytest
import torch

import chip_smoke
from gpu_bench import devtrace, roofline
from gpu_bench.genome import genome_bytes, make_genome
from gpu_bench.system import System


@pytest.fixture(scope="module")
def page():
    from crackling_tpu_torch.index import build_index
    from crackling_tpu_torch.index.extract import extract_offtarget_sites_seq
    from crackling_tpu_torch.ops.issl_compact import CompactIsslScorer

    from test_gpu_bench_reference import repeat_rich

    torch.set_num_threads(1)
    codes = np.concatenate([repeat_rich(seed=4, copies=60),
                            make_genome(np.random.default_rng(4), 200_000)])
    index = build_index(extract_offtarget_sites_seq(genome_bytes(codes)))
    scorer = CompactIsslScorer(index, max_dist=4, device="cpu", chunk=1024,
                               superchunk=2)
    queries = index.site_sigs[::5][:3000]
    q, qsp = chip_smoke.finder_inputs(scorer, queries)
    return scorer, queries, q, qsp, scorer.finder(q, qsp)


def test_finder_bound_is_chip_smokes(page):
    scorer, _queries, q, qsp, fo = page
    C = fo.cnt.shape[2]
    want = chip_smoke.finder_bound_ms(scorer, q, qsp, C)
    counts = roofline.slice_counts(q, scorer.S, scorer.B)
    got = roofline.finder_bound_ms(scorer.bucket_lens, counts, qsp.shape[2],
                                   q.numel(), C)
    assert got == want
    assert System(scorer.index, None, scorer, q.device).finder_cells == C


def test_rescan_bound_is_chip_smokes(page):
    scorer, _queries, q, qsp, fo = page
    rows = scorer.decode_tree(q, qsp, fo).rows
    assert rows.ridx.numel() > 0
    want = chip_smoke.rescan_bound_ms(scorer, rows, q.numel())
    got = roofline.rescan_bound_ms(rows, scorer.entries.reshape(-1),
                                   scorer._scan_width, scorer.max_dist,
                                   q.numel())
    assert got == want


def test_page_bound_counts_every_pair(page):
    scorer, queries, q, _qsp, _fo = page
    counts = roofline.slice_counts(q, scorer.S, scorer.B)
    _ms, by, pairs = roofline.page_bound_ms(scorer.bucket_lens, counts,
                                            q.numel())
    offs = scorer.index.bucket_offsets
    vals = scorer.index.slice_values(queries)
    want = sum(int(offs[s, v + 1] - offs[s, v])
               for s in range(scorer.S) for v in vals[s])
    assert pairs == want and by in ("tensor", "bytes")


class Ev:
    def __init__(self, name, start, end, device, span=False):
        self.name = name
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.is_user_annotation = span
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_trace_summary():
    events = [
        Ev(devtrace.WINDOW_SPAN, 0, 100, False, True),
        Ev("bench.pages", 10, 60, False, True),
        Ev("compact.plan", 10, 20, False, True),
        Ev("compact.plan", 10, 20, True, True),      # its device copy
        Ev("aten::sort", 10, 20, False),
        Ev("finder_kernel", 20, 40, True),
        Ev("rescan_kernel", 30, 50, True),           # overlaps the finder
        Ev("Memcpy DtoH", 70, 80, True),
    ]
    t = devtrace.summarize(events, window_s=1e-4)
    assert t.launches == 2
    assert t.busy_s == pytest.approx(40e-6)
    assert t.kernel_time("finder") == (1, pytest.approx(20e-6))
    # gaps: 0-20 in compact.plan (its midpoint, 10, is inside it), 50-70
    # in bench.pages, 80-100 in no span
    assert t.idle_by_span == {"compact.plan": pytest.approx(20e-6),
                              "bench.pages": pytest.approx(20e-6),
                              "(no span)": pytest.approx(20e-6)}
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]][0] in ("finder_kernel",
                                                  "rescan_kernel")
    assert len(b["idle_gaps"]) == 3
