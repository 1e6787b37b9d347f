"""Multi-process scoring in the port: two gloo processes over localhost.

Each test starts two real processes. In the first, each initialises the
process group, builds a ``('host', 'q', 'shard')`` mesh of four CPU
devices (host 2, q 2, shard 2), loads only its own site ranges of a
shared ``.issl`` file and scores a query page with the flat and the fast
(compact) sharded engine: both ranks must print the same bits, within
rtol 1e-12 of the single-process sums over the same four shards (only
the f64 order of the shards' partial sums differs) and within JAX's
sharded tier (rtol 2e-6 / atol 1e-6) of ``oracle.score_bruteforce``.
The deepest bucket lies in rank 0's ranges; with the compact rank bound
set between the two ranks' deepest buckets, both ranks must build the
dense engine. In the second, ``Crackling`` runs in two processes
(``process-count = 2``, ``cpu-devices = 2``) beside a one-process
``engine = sharded`` run: the two CSVs must be byte-equal, and equal to
the one-process CSV in every column but the scores, which agree within
1e-3.
"""

import csv
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from crackling_tpu_torch.constants import GUIDE_COLUMNS
from crackling_tpu_torch.index import build_index, write_reference_issl
from crackling_tpu_torch.ops.oracle import score_bruteforce
from crackling_tpu_torch.parallel import sharded
from test_torch_sharded import deepest, sites_and_queries

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300

SCORER_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    pid = int(sys.argv[1]); port = sys.argv[2]; tmp = sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    from crackling_tpu_torch.ops import issl_compact
    from crackling_tpu_torch.parallel import distributed as dist
    from crackling_tpu_torch.parallel import sharded
    dist.initialize(f"localhost:{port}", 2, pid)
    assert dist.process_count() == 2 and dist.process_index() == pid
    mesh = dist.host_mesh(n_q=2, devices=["cpu"] * 4)
    assert mesh.shape == {"host": 2, "q": 2, "shard": 2}
    issl = os.path.join(tmp, "g.issl")
    queries = np.load(os.path.join(tmp, "queries.npy"))
    flat = dist.multihost_scorer(issl, mesh, max_dist=4, query_block=16,
                                 work_block=1 << 10)
    fast = dist.multihost_fast_scorer(issl, mesh, max_dist=4, chunk=1024,
                                      query_page=32)
    assert type(fast) is sharded.ShardedCompactIsslScorer
    fm, fc = flat.score_sums(queries)
    cm, cc = fast.score_sums(queries)
    # a bound only rank 0's shards reach: both ranks fall back to dense
    issl_compact.RANK_BOUND = int(sys.argv[5])
    dense = dist.multihost_fast_scorer(issl, mesh, max_dist=4, chunk=1024,
                                       query_page=32)
    dm, dc = dense.score_sums(queries)
    np.savez(os.path.join(tmp, f"rank{pid}.npz"), flat=[fm, fc],
             compact=[cm, cc], dense=[dm, dc],
             fallback=type(dense).__name__)
    print(f"DIST_OK {pid}", flush=True)
""")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_all(procs):
    """Each process's output; a process that outlives TIMEOUT kills them
    all (a rank that died leaves the other waiting in a collective)."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return outs


def spawn(args, env=None):
    # one torch thread per process: the test runs beside other test workers
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=REPO)


def test_two_process_scoring(tmp_path):
    sites, queries = sites_and_queries()
    index = build_index(sites)
    write_reference_issl(index, str(tmp_path / "g.issl"))
    np.save(tmp_path / "queries.npy", queries)
    shards = sharded.shard_index(index, 4)
    rank_deepest = [max(map(deepest, shards[:2])),
                    max(map(deepest, shards[2:]))]
    assert rank_deepest[1] < rank_deepest[0]
    worker = tmp_path / "worker.py"
    worker.write_text(SCORER_WORKER)
    port = free_port()
    procs = [spawn([worker, pid, port, tmp_path, REPO, rank_deepest[1] + 1])
             for pid in (0, 1)]
    for pid, (p, out) in enumerate(zip(procs, wait_all(procs))):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DIST_OK {pid}" in out, out

    ranks = [np.load(tmp_path / f"rank{pid}.npz") for pid in (0, 1)]
    brute = score_bruteforce(queries, index.site_sigs, index.occurrences, 4)
    mesh = sharded.make_mesh(4, 1, ["cpu"] * 4)
    single = {
        "flat": sharded.ShardedIsslScorer(index, mesh, max_dist=4,
                                          query_block=16, work_block=1 << 10),
        "compact": sharded.ShardedCompactIsslScorer(index, mesh, max_dist=4,
                                                    chunk=1024),
        "dense": sharded.ShardedDenseIsslScorer(index, mesh, max_dist=4,
                                                chunk=1024)}
    for name, sc in single.items():
        want = sc.score_sums(queries)
        # the same bits on both ranks
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
        for got, w, b in zip(ranks[0][name], want, brute):
            np.testing.assert_allclose(got, w, rtol=1e-12, atol=0)
            np.testing.assert_allclose(got, b, rtol=2e-6, atol=1e-6)
    assert [str(r["fallback"]) for r in ranks] == \
        ["ShardedDenseIsslScorer"] * 2


CONFIG = """
[general]
name = mh
optimisation = high

[consensus]
n = 2
mm10db = True
sgrnascorer2 = True
chopchop = True

[input]
exon-sequences = {exons}
offtarget-sites = {issl}
gff-annotation =
bowtie2-index = {genome}
batch-size = 5000000

[output]
dir = {outdir}
filename = guides.txt
delimiter = ,

[offtargetscore]
enabled = True
binary = ignored
method = and
threads = 4
page-length = 5000000
score-threshold = 75
max-distance = 4

[sgrnascorer2]
model = shipped
score-threshold = 0

[bowtie2]
binary = ignored
threads = 4
page-length = 5000000

[rnafold]
binary = RNAfold
threads = 4
page-length = 5000000
low_energy_threshold = -30
high_energy_threshold = -18

[tpu]
engine = sharded
{tpu_extra}
"""


@pytest.fixture(scope="module")
def mh_world(tmp_path_factory):
    """tests/test_pipeline_multihost.py's world: a 30 kbp genome, one
    900 bp exon, its off-target sites as a reference .issl."""
    from crackling_tpu_torch.index.stream import build_index_from_sites_text
    from crackling_tpu_torch.utils import cli

    td = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chrom = bases[rng.integers(0, 4, 30_000)].tobytes().decode()
    genome = td / "genome.fa"
    genome.write_text(">chr1\n" + "\n".join(
        chrom[i:i + 70] for i in range(0, len(chrom), 70)) + "\n")
    exons = td / "exons.fa"
    exons.write_text(">exon1\n" + chrom[2000:2900] + "\n")
    sites = td / "sites.txt"
    cli.main_extract_offtargets([str(sites), str(genome)])
    issl = td / "g.issl"
    write_reference_issl(build_index_from_sites_text(str(sites)), str(issl))
    return dict(genome=genome, exons=exons, issl=issl)


def run_crackling(world, outdir, tpu_extra, env_extra=None):
    outdir.mkdir()
    cfg = outdir.parent / f"{outdir.name}.ini"
    cfg.write_text(CONFIG.format(exons=world["exons"], issl=world["issl"],
                                 genome=world["genome"], outdir=outdir,
                                 tpu_extra=tpu_extra))
    # no CRACKLING_PLATFORM: [tpu] cpu-devices alone puts the run on the CPU
    env = {k: v for k, v in os.environ.items()
           if k not in ("CRACKLING_PLATFORM", "CRACKLING_PROCESS_ID")}
    env.update(env_extra or {})
    return spawn(["-m", "crackling_tpu_torch.utils.run_cli", "Crackling",
                  "-c", cfg], env=env)


def test_two_process_crackling_matches_one(mh_world, tmp_path):
    port = free_port()
    multi = (f"coordinator-address = localhost:{port}\n"
             "process-count = 2\ncpu-devices = 2\nmesh-q = 1\n")
    procs = [
        # process 0 names its id in the config, process 1 in the variable
        run_crackling(mh_world, tmp_path / "proc0",
                      multi + "process-id = 0\n"),
        run_crackling(mh_world, tmp_path / "proc1", multi,
                      {"CRACKLING_PROCESS_ID": "1"}),
        # one process over the same four shards
        run_crackling(mh_world, tmp_path / "single", "cpu-devices = 4\n")]
    names = ("proc0", "proc1", "single")
    outs = dict(zip(names, wait_all(procs)))
    for name, p in zip(names, procs):
        assert p.returncode == 0, f"{name} failed:\n{outs[name][-4000:]}"
    assert "torch.distributed: process 1 of 2 (2 devices)" in outs["proc1"]
    csvs = {name: tmp_path / name / "mh-guides.txt" for name in names}
    assert csvs["proc0"].read_bytes() == csvs["proc1"].read_bytes()

    def rows(path):
        with open(path) as fp:
            return list(csv.reader(fp))

    multi_rows, single_rows = rows(csvs["proc0"]), rows(csvs["single"])
    assert multi_rows[0] == GUIDE_COLUMNS
    assert len(multi_rows) == len(single_rows) > 10
    col = {c: i for i, c in enumerate(GUIDE_COLUMNS)}
    scores = {col["mitOfftargetscore"], col["cfdOfftargetscore"]}
    scored = 0
    for rm, rs in zip(multi_rows[1:], single_rows[1:]):
        for i, (a, b) in enumerate(zip(rm, rs)):
            if i in scores and a not in ("?", "-") and b not in ("?", "-"):
                assert abs(float(a) - float(b)) < 1e-3, (i, a, b)
                scored += 1
            else:
                assert a == b, (GUIDE_COLUMNS[i], a, b)
    assert scored > 0, "no guide reached off-target scoring"
