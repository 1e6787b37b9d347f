"""The end-to-end guide-design pipeline (reference ``Crackling()`` equivalent).

Behavioral contract follows /root/reference/src/crackling/Crackling.py:17-893
— same module sequence, same optimisation-level gating
(``filterCandidateGuides``, Crackling.py:36-149), same 26-column CSV — with
the architecture re-designed around a **columnar guide table**: guides are
2-bit signatures in numpy arrays, every scorer is a batched array op, and
the specificity stages run the in-process GPU engines instead of
temp-file/subprocess hops. Off-target scoring runs on the pipeline's
device: ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np
import torch

from .. import trace
from ..codec import sigs_to_strings
from ..constants import (
    CODE_ACCEPTED,
    CODE_AMBIGUOUS,
    CODE_REJECTED,
    CODE_UNTESTED,
    GUIDE_COLUMNS,
    MODULE_CHOPCHOP,
    MODULE_MM10DB,
    MODULE_SGRNASCORER2,
    MODULE_SPECIFICITY,
)
from ..device import resolve_device
from ..index import load_native, read_reference_issl
from ..index.extract import find_candidate_guides_seq
from ..ops import efficiency as eff
from .logger import printer
from .metrics import Metrics, ResumeManifest, config_fingerprint
from .positioning import GenomeIndex, position_guides
from .secondary_structure import SecondaryStructureGate


class GuideTable:
    """Columnar per-batch guide state (replaces the per-guide dicts).

    Guides stay uint64 signatures end-to-end; the 23-mer strings are
    rendered once (vectorized) for the CSV/secondary-structure surfaces
    instead of round-tripping every candidate through Python strings
    (the O(guides) dict loops SURVEY flags at Crackling.py:283-304)."""

    def __init__(self, sig23, headers, starts, ends, strands, is_dup):
        self.n = len(sig23)
        self.sig23 = np.asarray(sig23, dtype=np.uint64)
        self.seq = np.array(sigs_to_strings(self.sig23, 23), dtype=object) \
            if self.n else np.zeros(0, dtype=object)
        o = lambda v: np.array([v] * self.n, dtype=object)
        self.col = {name: o(CODE_UNTESTED) for name in GUIDE_COLUMNS}
        self.col["seq"] = self.seq
        self.col["isUnique"] = np.where(is_dup, CODE_REJECTED, CODE_ACCEPTED).astype(object)
        self.col["header"] = np.where(is_dup, CODE_AMBIGUOUS, np.asarray(headers, dtype=object))
        self.col["start"] = np.where(is_dup, CODE_AMBIGUOUS,
                                     np.asarray(starts).astype(object))
        self.col["end"] = np.where(is_dup, CODE_AMBIGUOUS,
                                   np.asarray(ends).astype(object))
        self.col["strand"] = np.where(is_dup, CODE_AMBIGUOUS, np.asarray(strands, dtype=object))

    def eq(self, name, value):
        if self.n == 0:
            return np.zeros(0, dtype=bool)
        return self.col[name] == value

    def set_where(self, name, mask, values):
        self.col[name][mask] = values

    def rows(self):
        for i in range(self.n):
            yield [self.col[c][i] for c in GUIDE_COLUMNS]


def select_auto_engine(index, device) -> str:
    """Resolve ``engine = auto`` as the JAX package does (its TPU maps to
    CUDA here, its CPU to the CPU): on CUDA at the l=20 / w=8 operating
    point, the hybrid compact engine (compact full scan on the GPU + exact
    re-score of near-threshold queries, verdict-exact for every method);
    on the CPU and at every other operating point, the general exact
    engine (``xla``, ``ops/issl_flat.py``). The compact engine takes
    buckets of up to 2^30 entries (``issl_compact.RANK_BOUND``: int32
    ranks; the JAX engine's f32 decode stops at 2^22), as deep as a
    mammal's whole-genome index; past that, or where its lists do not fit
    the card, ``_get_issl_scorer`` falls back to the dense engine."""
    if (torch.device(device).type != "cuda" or index.seq_length != 20
            or index.slice_width != 8):
        return "xla"
    return "compact"


def verdicts(mit, cfd, threshold: float, method: str) -> np.ndarray:
    """Accept/reject per the score method (reference Crackling.py:797-835).

    True == accepted (score not below threshold under the method)."""
    mit = np.asarray(mit)
    cfd = np.asarray(cfd)
    if method == "mit":
        rejected = mit < threshold
    elif method == "cfd":
        rejected = cfd < threshold
    elif method == "and":
        rejected = (mit < threshold) & (cfd < threshold)
    elif method == "or":
        rejected = (mit < threshold) | (cfd < threshold)
    elif method == "avg":
        rejected = (mit + cfd) / 2.0 < threshold
    else:
        raise ValueError(f"unknown score method: {method}")
    return ~rejected


def _batched(idx: np.ndarray, page_len: int):
    """Chunk an index array into pages (page_len 0 => a single page),
    mirroring the reference Paginator semantics (Paginator.py:26-47)."""
    if page_len <= 0 or idx.size <= page_len:
        yield idx
        return
    for i in range(0, idx.size, page_len):
        yield idx[i:i + page_len]


class Pipeline:
    def __init__(self, config_mngr, device=None):
        self.cm = config_mngr
        # cuda unless the caller (or [tpu] cpu-devices) asks for the CPU;
        # raises without a GPU
        self._local_devices = self._maybe_init_distributed(device)
        self.device = self._local_devices[0]
        self._issl_scorer = None
        self._genome_index = None
        profile_dir = None
        if config_mngr._parser.has_section("tpu"):
            profile_dir = config_mngr["tpu"].get("profile-dir", None)
        self.metrics = Metrics(profile_dir=profile_dir or None)

    def _maybe_init_distributed(self, device):
        """``[tpu]`` multi-process keys -> ``torch.distributed``; returns
        this process's devices (``parallel/distributed.local_devices``).

        Keys (all optional; absent => single-process, the default):

        * ``coordinator-address`` — ``host:port`` of process 0
        * ``process-count`` — world size (> 1 enables multi-process)
        * ``process-id`` — this process's id; falls back to the
          ``CRACKLING_PROCESS_ID`` env var so every process can share one
          config file
        * ``cpu-devices`` — test mode: N CPU devices per process in place
          of the GPU (the JAX package's virtual CPU devices)
        * ``mesh-q`` — query axis size of the ('host','q','shard') mesh
          used by ``engine = sharded``

        Every process runs the identical pipeline on the identical inputs
        (give each a distinct ``[output] dir``); the ISSL scoring stage is
        the collective part — each process loads only its own site ranges
        and the per-query partial sums are all-reduced across processes,
        so all processes emit identical scores. On CUDA each process takes
        card ``process-id % cards``."""
        from ..parallel import distributed as dist

        tpu = self.cm["tpu"]
        count = int(tpu.get("process-count", "") or "1")
        cpu_devices = int(tpu.get("cpu-devices", "") or "0")
        device = resolve_device("cpu" if cpu_devices else device)
        if count > 1:
            addr = tpu.get("coordinator-address", "") or ""
            if not addr:
                raise ValueError(
                    "[tpu] process-count > 1 requires coordinator-address")
            pid = tpu.get("process-id", "") or os.environ.get(
                "CRACKLING_PROCESS_ID", "")
            if pid == "":
                raise ValueError("[tpu] process-id (or the "
                                 "CRACKLING_PROCESS_ID env var) is required "
                                 "when process-count > 1")
            dist.initialize(addr, count, int(pid))
        devices = dist.local_devices(device, cpu_devices)
        if devices[0].type == "cuda":
            # the kernels launch on the current device
            torch.cuda.set_device(devices[0])
        if count > 1:
            printer(f"torch.distributed: process {dist.process_index()} of "
                    f"{dist.process_count()} ({len(devices)} devices)")
        return devices

    # -- gating ---------------------------------------------------------

    def filter_mask(self, t: GuideTable, module: str) -> np.ndarray:
        """Vectorized ``filterCandidateGuides`` (reference Crackling.py:36-149)."""
        cm = self.cm
        module = module.lower()
        opt = cm["general"]["optimisation"]
        n = int(cm["consensus"]["n"])
        assess = np.ones(t.n, dtype=bool)
        if opt in ("low", "medium", "high"):
            assess &= ~t.eq("isUnique", CODE_REJECTED)

        def mm10db_failed():
            bad = np.zeros(t.n, dtype=bool)
            for f in ("passedAvoidLeadingT", "passedATPercent", "passedTTTT",
                      "passedSecondaryStructure", "acceptedByMm10db"):
                bad |= t.eq(f, CODE_REJECTED)
            return bad

        if opt == "medium":
            if module == MODULE_MM10DB:
                assess &= ~mm10db_failed()
            if module == MODULE_SPECIFICITY:
                assess &= ~(t.col["consensusCount"].astype(int) < n)
                assess &= ~t.eq("passedBowtie", CODE_REJECTED)

        if opt == "high":
            if module in (MODULE_CHOPCHOP, MODULE_MM10DB, MODULE_SGRNASCORER2):
                acc = sum(
                    t.eq(f, CODE_ACCEPTED).astype(int)
                    for f in ("acceptedByMm10db", "passedG20", "acceptedBySgRnaScorer")
                )
                assessed = sum(
                    (t.eq(f, CODE_ACCEPTED) | t.eq(f, CODE_REJECTED)).astype(int)
                    for f in ("acceptedByMm10db", "passedG20", "acceptedBySgRnaScorer")
                )
                tools = sum(
                    self.cm["consensus"].getboolean(k)
                    for k in ("mm10db", "chopchop", "sgrnascorer2")
                )
                assess &= ~(acc >= n)
                assess &= ~(tools - assessed < n - acc)
                if module == MODULE_MM10DB:
                    assess &= ~mm10db_failed()
            if module == MODULE_SPECIFICITY:
                assess &= ~(t.col["consensusCount"].astype(int) < n)
                assess &= ~t.eq("passedBowtie", CODE_REJECTED)
        return assess

    # -- stage A: extraction -------------------------------------------

    _SPILL_COLS = (("sig23", np.uint64), ("start", np.int64),
                   ("strand", np.int8), ("hid", np.int32))

    def extract_candidates(self):
        """Scan input files; returns memory-mapped candidate records plus
        the scan-order first-occurrence index (``keep``) and the duplicate
        set (reference Crackling.py:171-261).

        Candidate columns spill to disk *during* the scan (the reference's
        Batchinator.recordEntry role, Batchinator.py:26-42), so resident
        memory during extraction is one sequence plus the spill buffers —
        never the whole candidate table. The dedup pass holds one
        8 B/candidate signature array (the reference holds every candidate
        as a Python string in its candidateGuides set, Crackling.py:223)."""
        cm = self.cm
        recorded_sequences: set[str] = set()

        import tempfile

        spill_dir = tempfile.mkdtemp(
            prefix="crackling-batches-", dir=cm["output"]["dir"])
        self._spill_dir = spill_dir  # kept until the run completes
        files = {k: open(os.path.join(spill_dir, f"{k}.bin"), "wb")
                 for k, _ in self._SPILL_COLS}

        headers: list[str] = []
        n_total = 0
        file_bounds = [0]
        file_paths = []
        try:
            for path in cm.getIterFilesToProcess():
                printer(f"Identifying possible target sites in: {path}")
                file_paths.append(path)
                # replicate the reference's previous-header gating incl.
                # the always-process-the-last-sequence quirk
                # (Crackling.py:207-252)
                for header, seq, is_last in self._iter_fasta(path):
                    if (not is_last and header in recorded_sequences
                            and header != ""):
                        continue
                    if not is_last and header == "" and seq == "":
                        continue
                    recorded_sequences.add(header)
                    starts, strands, sigs = find_candidate_guides_seq(seq)
                    hid = len(headers)
                    headers.append(header)
                    sigs.astype(np.uint64).tofile(files["sig23"])
                    starts.astype(np.int64).tofile(files["start"])
                    (strands == "-").astype(np.int8).tofile(files["strand"])
                    np.full(sigs.shape[0], hid,
                            dtype=np.int32).tofile(files["hid"])
                    n_total += int(sigs.shape[0])
                file_bounds.append(n_total)
        finally:
            for fp in files.values():
                fp.close()

        def mapped(key, dtype):
            path = os.path.join(spill_dir, f"{key}.bin")
            if n_total == 0:
                return np.zeros(0, dtype=dtype)
            return np.memmap(path, dtype=dtype, mode="r")

        records = {k: mapped(k, dt) for k, dt in self._SPILL_COLS}
        records["headers"] = headers

        # first-occurrence dedup in scan order; count>1 => duplicate
        # guide. np.unique materializes the signature column once
        # (8 B/candidate — the only whole-input allocation in stage A).
        uniq, first, counts = np.unique(records["sig23"],
                                        return_index=True,
                                        return_counts=True)
        records["keep"] = np.sort(first)          # record idx, scan order
        dup_sigs = np.sort(uniq[counts > 1])

        for f in range(len(file_paths)):
            lo, hi = file_bounds[f], file_bounds[f + 1]
            n_file = hi - lo
            n_first = int(((first >= lo) & (first < hi)).sum())
            printer(f"\tIdentified {n_file:,} possible target sites in "
                    "this file.")
            printer(f"\tRemoving {n_file - n_first:,} duplicate-occurrence "
                    "guides.")
        return records, dup_sigs

    @classmethod
    def _iter_fasta(cls, path):
        """Lazily yield (header, joined-sequence, is_last) — one sequence
        resident at a time (the reference also processes per sequence,
        Crackling.py:193-238); '' header for leading headerless content."""
        gen = cls._fasta_pairs(path)
        prev = next(gen, None)
        if prev is None:
            return
        for cur in gen:
            yield prev[0], prev[1], False
            prev = cur
        yield prev[0], prev[1], True

    @staticmethod
    def _fasta_pairs(path):
        """Streaming equivalent of the reference's strip-line-breaks parse:
        the initial ('', '') pair is never yielded unless content precedes
        a header (Crackling.py:193-238 state machine)."""
        header = ""
        seq_parts: list[str] = []
        idx = 0
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                if line[0] == ">":
                    pair = (header, "".join(seq_parts))
                    if idx > 0 or pair != ("", ""):
                        yield pair
                    idx += 1
                    header = line[1:]
                    seq_parts = []
                else:
                    seq_parts.append(line)
        pair = (header, "".join(seq_parts))
        if idx > 0 or pair != ("", ""):
            yield pair

    # -- specificity helpers -------------------------------------------

    def _get_issl_scorer(self):
        if self._issl_scorer is not None:
            return self._issl_scorer
        cm = self.cm
        path = cm["input"]["offtarget-sites"]
        printer(f"Loading off-target index: {path}")
        with trace.span("index.load"):
            if path.endswith(".npz"):
                index = load_native(path)
            elif path.endswith(".issl"):
                index, _ = read_reference_issl(path)
            else:
                # site text list: streamed build, memory bounded by the
                # distinct-site count (never the file size)
                from ..index.stream import build_index_from_sites_text

                index = build_index_from_sites_text(path, seq_length=20,
                                                    slice_width=8)
        method = cm["offtargetscore"]["method"].strip().lower()
        md = int(cm["offtargetscore"]["max-distance"])
        threshold = float(cm["offtargetscore"]["score-threshold"])
        engine = cm["tpu"].get("engine", "auto")
        if engine == "auto":
            engine = select_auto_engine(index, self.device)
            if engine == "compact":
                printer(f"engine auto: {engine} on {self.device} (avg "
                        f"bucket depth "
                        f"{index.num_sites / index.bucket_count:,.0f})")
        if engine == "exact":
            engine = "mxu"
        if engine == "mxu":
            # bit-exact %f score parity for every method: the neighbour
            # finder on the device, the f64 replay on the host
            from ..ops.issl_mxu import MxuIsslScorer

            try:
                self._issl_scorer = MxuIsslScorer(
                    index, max_dist=md, method=method, threshold=threshold,
                    device=self.device)
                return self._issl_scorer
            except ValueError as e:
                # a bucket past the MXU engine's rank bound, or an index
                # too large for the device's free memory: fall back to the
                # order-exact general engine
                printer(f"MXU engine unavailable ({e}); using the exact "
                        "XLA engine")
                engine = "xla"
        if engine == "compact":
            # two-phase compact engine (finder kernel -> hit-moment
            # compaction -> sparse f32 scoring) wrapped in the hybrid's
            # exact near-threshold re-score for verdict exactness on all
            # five methods. A bucket past the moment decoder's rank bound
            # (2^30 entries, int32 ranks; far deeper than a mammal's
            # index), or lists, their build and a page that do not fit
            # the device's free memory beside the exact re-scorer's room,
            # fall back to the dense engine, which has no depth bound.
            from ..ops.hybrid import HybridIsslScorer
            from ..ops.issl_compact import CompactIsslScorer

            fast = None
            try:
                fast = CompactIsslScorer(index, max_dist=md,
                                         device=self.device)
            except ValueError as e:
                printer(f"compact engine unavailable ({e}); using the "
                        "dense engine")
            self._issl_scorer = HybridIsslScorer(
                index, max_dist=md, method=method, threshold=threshold,
                dense=fast, device=self.device)
        elif engine == "dense":
            # dense full scan with the exact re-score of near-threshold
            # queries: verdict-exact for every method
            from ..ops.hybrid import HybridIsslScorer

            self._issl_scorer = HybridIsslScorer(
                index, max_dist=md, method=method, threshold=threshold,
                device=self.device)
        elif engine == "sharded":
            # the fastest engine over every local device: site-range index
            # shards + one all_reduce of the per-query partial sums, with
            # the hybrid's exact near-threshold re-score over the whole
            # index on top. Compact engine per shard; dense past the
            # compact decoder's bucket-depth bound. With [tpu]
            # process-count > 1 each process loads only its own site
            # ranges from the .issl file.
            from ..ops.hybrid import HybridIsslScorer
            from ..parallel import distributed as dist
            from ..parallel.sharded import (ShardedCompactIsslScorer,
                                            ShardedDenseIsslScorer,
                                            make_mesh)

            if dist.process_count() > 1:
                if not path.endswith(".issl"):
                    raise ValueError(
                        "[tpu] engine = sharded across processes requires "
                        "the offtarget-sites input to be a reference-"
                        "format .issl file (per-process site-range "
                        "loading)")
                n_q = int(cm["tpu"].get("mesh-q", "") or "1")
                mesh = dist.host_mesh(n_q=n_q, devices=self._local_devices)
                printer(f"multihost mesh: {mesh.shape}")
                fast = dist.multihost_fast_scorer(path, mesh, max_dist=md)
            else:
                mesh = make_mesh(n_q=1, devices=self._local_devices)
                try:
                    fast = ShardedCompactIsslScorer(index, mesh, max_dist=md)
                except ValueError as e:
                    printer(f"sharded compact unavailable ({e}); using "
                            "the sharded dense engine")
                    fast = ShardedDenseIsslScorer(index, mesh, max_dist=md)
            self._issl_scorer = HybridIsslScorer(
                index, max_dist=md, method=method, threshold=threshold,
                dense=fast)
        elif engine == "pallas":
            # the scan-style full scan (the JAX package's Pallas engine),
            # with no re-score, as there
            from ..ops.issl_scan import ScanIsslScorer

            self._issl_scorer = ScanIsslScorer(index, max_dist=md,
                                               device=self.device)
        elif engine == "xla":
            # the order-exact general engine with the early-exit
            # emulation: f64 on the CPU, TwoSum-compensated f32 on the GPU
            from ..ops.issl_flat import IsslScorer, default_dtype

            self._issl_scorer = IsslScorer(
                index, max_dist=md, method=method, threshold=threshold,
                dtype=default_dtype(self.device), device=self.device)
        else:
            raise ValueError(f"unknown [tpu] engine: {engine}")
        return self._issl_scorer

    def _get_genome_index(self):
        if self._genome_index is None:
            path = self.cm["input"]["bowtie2-index"]
            printer(f"Loading genome for positioning: {path}")
            self._genome_index = GenomeIndex.from_fasta(path)
        return self._genome_index

    # -- batch processing ----------------------------------------------

    def process_batch(self, t: GuideTable, csv_writer):
        cm = self.cm
        consensus_n = int(cm["consensus"]["n"])

        if cm["consensus"].getboolean("chopchop"):
            printer("CHOPCHOP - remove those without G in position 20.")
            m = self.filter_mask(t, MODULE_CHOPCHOP)
            ok = eff.g20_pass(t.sig23[m])
            t.set_where("passedG20", m, np.where(ok, CODE_ACCEPTED, CODE_REJECTED).astype(object))
            printer(f"\t{int((~ok).sum()):,} of {int(m.sum()):,} failed here.")

        if cm["consensus"].getboolean("mm10db"):
            printer("mm10db - remove all targets with a leading T (+) or trailing A (-).")
            m = self.filter_mask(t, MODULE_MM10DB)
            ok = eff.leading_t_trailing_a_pass(t.sig23[m])
            t.set_where("passedAvoidLeadingT", m,
                        np.where(ok, CODE_ACCEPTED, CODE_REJECTED).astype(object))
            printer(f"\t{int((~ok).sum()):,} of {int(m.sum()):,} failed here.")

            printer("mm10db - remove based on AT percent.")
            m = self.filter_mask(t, MODULE_MM10DB)
            at = eff.at_percentages(t.sig23[m])
            ok = eff.at_percent_pass(at)
            t.set_where("passedATPercent", m,
                        np.where(ok, CODE_ACCEPTED, CODE_REJECTED).astype(object))
            t.set_where("AT", m, np.array([float(x) for x in at], dtype=object))
            printer(f"\t{int((~ok).sum()):,} of {int(m.sum()):,} failed here.")

            printer("mm10db - remove all targets that contain TTTT.")
            m = self.filter_mask(t, MODULE_MM10DB)
            ok = eff.tttt_pass(t.sig23[m])
            t.set_where("passedTTTT", m,
                        np.where(ok, CODE_ACCEPTED, CODE_REJECTED).astype(object))
            printer(f"\t{int((~ok).sum()):,} of {int(m.sum()):,} failed here.")

            printer("mm10db - check secondary structure.")
            ss_timer = self.metrics.stage("secondary_structure")
            ss_timer.__enter__()
            # config-determined: build once per run (the constructor
            # installs the parameter file and rebuilds the Turner tables)
            gate = getattr(self, "_ss_gate", None)
            if gate is None:
                gate = self._ss_gate = SecondaryStructureGate(
                    backend=cm["tpu"].get("rnafold-backend", "auto"),
                    binary=cm["rnafold"]["binary"],
                    threads=int(cm["rnafold"]["threads"]),
                    low_energy_threshold=float(
                        cm["rnafold"]["low_energy_threshold"]),
                    high_energy_threshold=float(
                        cm["rnafold"]["high_energy_threshold"]),
                    parameter_file=cm["rnafold"].get("parameter-file", "")
                    or None,
                    device=self.device,
                )
            pg_len = int(cm["rnafold"]["page-length"])
            m = self.filter_mask(t, MODULE_MM10DB)
            for page in _batched(np.flatnonzero(m), pg_len):
                res = gate.assess([t.seq[i] for i in page])
                t.col["passedSecondaryStructure"][page] = res["verdict"]
                t.col["ssL1"][page] = res["ssL1"]
                t.col["ssStructure"][page] = res["ssStructure"]
                t.col["ssEnergy"][page] = res["ssEnergy"]

            ss_timer.__exit__(None, None, None)

            printer("Calculating mm10db final result.")
            # over ALL guides, no filter (reference Crackling.py:518-534)
            all_ok = np.ones(t.n, dtype=bool)
            for f in ("passedATPercent", "passedTTTT",
                      "passedSecondaryStructure", "passedAvoidLeadingT"):
                all_ok &= t.eq(f, CODE_ACCEPTED)
            t.col["acceptedByMm10db"] = np.where(
                all_ok, CODE_ACCEPTED, CODE_REJECTED
            ).astype(object)
            printer(f"\t{int(all_ok.sum())} accepted.")

        if cm["consensus"].getboolean("sgrnascorer2"):
            printer("sgRNAScorer2 - score using model.")
            m = self.filter_mask(t, MODULE_SGRNASCORER2)
            scores = eff.sgrnascorer2_scores(t.sig23[m])
            thresh = float(cm["sgrnascorer2"]["score-threshold"])
            ok = scores >= thresh
            t.set_where("sgrnascorer2score", m,
                        np.array([float(s) for s in scores], dtype=object))
            t.set_where("acceptedBySgRnaScorer", m,
                        np.where(ok, CODE_ACCEPTED, CODE_REJECTED).astype(object))
            printer(f"\t{int((~ok).sum()):,} of {int(m.sum()):,} failed here.")

        printer("Evaluating efficiency via consensus approach.")
        cc = sum(
            t.eq(f, CODE_ACCEPTED).astype(int)
            for f in ("acceptedByMm10db", "acceptedBySgRnaScorer", "passedG20")
        )
        t.col["consensusCount"] = cc.astype(object)
        printer(f"\t{int((cc < consensus_n).sum()):,} of {t.n:,} failed here.")

        if cm["offtargetscore"].getboolean("enabled"):
            printer("Bowtie-equivalent positioning analysis.")
            pos_timer = self.metrics.stage("positioning")
            pos_timer.__enter__()
            genome = self._get_genome_index()
            pg_len = int(cm["bowtie2"]["page-length"])
            m = self.filter_mask(t, MODULE_SPECIFICITY)
            for page in _batched(np.flatnonzero(m), pg_len):
                passed, chrom, start, end = position_guides(t.sig23[page], genome)
                t.col["passedBowtie"][page] = np.where(
                    passed, CODE_ACCEPTED, CODE_REJECTED).astype(object)
                t.col["bowtieChr"][page] = chrom
                t.col["bowtieStart"][page] = np.array([int(x) for x in start], dtype=object)
                t.col["bowtieEnd"][page] = np.array([int(x) for x in end], dtype=object)
            printer(f"\tpositioned {int(m.sum()):,} guides.")
            pos_timer.__exit__(None, None, None)

            printer("Beginning off-target scoring.")
            ot_timer = self.metrics.stage("offtarget_scoring")
            ot_timer.__enter__()
            scorer = self._get_issl_scorer()
            method = cm["offtargetscore"]["method"].strip().lower()
            threshold = float(cm["offtargetscore"]["score-threshold"])
            pg_len = int(cm["offtargetscore"]["page-length"])
            m = self.filter_mask(t, MODULE_SPECIFICITY)
            failed = 0
            for page in _batched(np.flatnonzero(m), pg_len):
                with self.metrics.stage("offtarget_unique"):
                    sigs20 = t.sig23[page] & np.uint64((1 << 40) - 1)
                    uniq, inv = np.unique(sigs20, return_inverse=True)
                with self.metrics.stage("offtarget_score"):
                    mit_u, cfd_u = scorer.score(uniq)
                with self.metrics.stage("offtarget_format"):
                    # round-trip through the reference's %f output
                    # formatting so emitted values match the subprocess
                    # pipeline exactly
                    mit = np.array([float(f"{x:.6f}") for x in mit_u])[inv]
                    cfd = np.array([float(f"{x:.6f}") for x in cfd_u])[inv]
                    calc_mit = method in ("mit", "and", "or", "avg")
                    calc_cfd = method in ("cfd", "and", "or", "avg")
                    t.col["mitOfftargetscore"][page] = np.array(
                        [float(x) for x in mit] if calc_mit
                        else [-1.0] * len(page), dtype=object)
                    t.col["cfdOfftargetscore"][page] = np.array(
                        [float(x) for x in cfd] if calc_cfd
                        else [-1.0] * len(page), dtype=object)
                ok = verdicts(mit, cfd, threshold, method)
                t.col["passedOffTargetScore"][page] = np.where(
                    ok, CODE_ACCEPTED, CODE_REJECTED).astype(object)
                failed += int((~ok).sum())
            ot_timer.__exit__(None, None, None)
            printer(f"\t{failed:,} of {int(m.sum()):,} failed here.")

        printer("Writing results to file.")
        csv_writer.writerows(zip(*(t.col[c] for c in GUIDE_COLUMNS)))

    # -- top level ------------------------------------------------------

    def run(self):
        cm = self.cm
        start_time = time.time()
        _stdout, _stderr = sys.stdout, sys.stderr
        sys.stdout = cm.getLogMethod()
        sys.stderr = cm.getErrLogMethod()
        try:
            out_path = cm["output"]["file"]
            delim = cm["output"]["delimiter"]
            self.metrics.path = out_path + ".metrics.json"
            manifest = ResumeManifest(out_path, config_fingerprint(cm._parser))
            resume = (cm["output"].getboolean("resume", fallback=False)
                      and os.path.exists(out_path))
            if resume and not manifest.exists():
                printer("Output exists with no resume manifest - the previous "
                        "run completed; nothing to resume.")
                return
            start_batch = manifest.load() if resume else 0
            if start_batch:
                printer(f"Resuming: {start_batch} batch(es) already complete.")

            printer("Analysing files...")
            with self.metrics.stage("extract_candidates"):
                records, dup_sigs = self.extract_candidates()
            n_records = records["keep"].shape[0]
            self.metrics.count("candidates", n_records)
            self.metrics.count("duplicates", int(dup_sigs.shape[0]))

            if start_batch == 0 and not (resume and manifest.exists()):
                with open(out_path, "a+", newline="") as fp:
                    w = csv.writer(fp, delimiter=delim, quotechar='"',
                                   dialect="unix", quoting=csv.QUOTE_MINIMAL)
                    w.writerow(GUIDE_COLUMNS)
                # manifest exists from the first byte on: a crash anywhere
                # in batch 0 resumes by truncating back to the header
                manifest.mark(0, 0)

            batch_size = int(cm["input"]["batch-size"])
            n_batches = max(1, -(-n_records // batch_size)) if n_records else 0
            headers_arr = np.array(records["headers"], dtype=object)
            strand_lut = np.array(["+", "-"], dtype=object)
            for b in range(n_batches):
                if b < start_batch:
                    continue
                printer(f"Processing batch file {b + 1:,} of {n_batches}")
                # the candidate columns are spilled memmaps (extraction
                # wrote them streaming); gathering by the batch's keep
                # indices materializes one batch at a time — resident
                # memory is bounded by the working batch, not the input
                # (the Batchinator temp-CSV role, Batchinator.py:26-42,
                # without the text round trip)
                idx = records["keep"][b * batch_size:(b + 1) * batch_size]
                sig23 = np.asarray(records["sig23"][idx])
                # duplicate marking: binary search into the sorted dup set
                pos = np.searchsorted(dup_sigs, sig23)
                pos = np.minimum(pos, max(dup_sigs.shape[0] - 1, 0))
                is_dup = (dup_sigs[pos] == sig23) if dup_sigs.size else \
                    np.zeros(sig23.shape[0], dtype=bool)
                starts = np.asarray(records["start"][idx])
                t = GuideTable(
                    sig23,
                    headers_arr[np.asarray(records["hid"][idx])],
                    starts,
                    starts + 23,
                    strand_lut[np.asarray(records["strand"][idx])],
                    is_dup,
                )
                printer(f"\tLoaded {t.n:,} guides")
                with self.metrics.stage("process_batches"):
                    with open(out_path, "a+", newline="") as fp:
                        w = csv.writer(fp, delimiter=delim, quotechar='"',
                                       dialect="unix", quoting=csv.QUOTE_MINIMAL)
                        self.process_batch(t, w)
                self.metrics.count("guides_evaluated", t.n)
                manifest.mark(b + 1, n_batches)
                printer(f"{t.n} guides evaluated.")
            manifest.finish()
            if getattr(self, "_spill_dir", None):
                records = None
                import shutil

                shutil.rmtree(self._spill_dir, ignore_errors=True)
                self._spill_dir = None
            self.metrics.flush()
            self.metrics.close()
            printer("Total run time {} seconds".format(time.time() - start_time))
        finally:
            sys.stdout = _stdout
            sys.stderr = _stderr


def Crackling(config_mngr, device=None):
    """Reference-compatible entry point (Crackling.py:17); ``device``
    defaults to ``cuda``."""
    Pipeline(config_mngr, device=device).run()
