"""Console entry points of the PyTorch package.

``Crackling`` (the pipeline), ``scoreOfftargets`` (isslScoreOfftargets'
CLI and stdout format), ``extractOfftargets``, ``createIsslIndex``
(isslCreateIndex), ``trainModel`` (sgRNAScorer 2.0's SVM) and
``countHitTranscripts``, as in crackling_tpu/utils/cli.py. The scoring entry
points run on ``cuda``; ``CRACKLING_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..device import cli_device, score_offtargets_placement


def main_crackling(argv=None):
    """``Crackling -c config.ini`` (reference Crackling_cli.py:8-21)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True,
                        help="The config file for Crackling")
    args = parser.parse_args(argv)

    from ..pipeline.config import ConfigManager
    from ..pipeline.logger import printer
    from ..pipeline.run import Crackling

    device = cli_device()
    cm = ConfigManager(args.config, lambda x: print(f"configMngr says: {x}"))
    if not cm.isConfigured():
        print("Something went wrong with reading the configuration.")
        sys.exit(1)
    printer(f"Crackling (PyTorch, {device}) is starting...")
    Crackling(cm, device=device)


def main_extract_offtargets(argv=None):
    """``extractOfftargets out.txt inputs...``
    (reference extractOfftargets.py:255-298): writes the sorted site list."""
    parser = argparse.ArgumentParser(
        description="Extract off-target sites for the ISSL index.")
    parser.add_argument("output")
    parser.add_argument("inputs", nargs="+")
    parser.add_argument("--threads", type=int, default=None,
                        help="scan worker threads (default: all cores; the "
                             "reference's multiprocessing fan-out role)")
    parser.add_argument("--maxOpenFiles", type=int, default=None,
                        help="accepted for compatibility")
    parser.add_argument("--run-size", type=int,
                        default=64 * 1024 * 1024,
                        help="external-sort spill run size (signatures)")
    args = parser.parse_args(argv)

    import glob

    from ..index.stream import stream_sorted_sites, write_sites_text
    from ..pipeline.logger import printer

    inputs = list(args.inputs)
    if len(inputs) == 1 and os.path.isdir(inputs[0]):
        inputs = sorted(glob.glob(os.path.join(inputs[0], "*")))

    # memory-bounded path: chunked scan -> sorted spill runs -> merge
    # cascade -> streamed text writer
    total, blocks = stream_sorted_sites(inputs, run_size=args.run_size,
                                        threads=args.threads)
    write_sites_text(blocks, args.output)
    printer(f"Processing completed. Found {total:,} targets.")
    printer("Goodbye.")


def main_create_issl_index(argv=None):
    """``createIsslIndex offtargetSites.txt seqLength sliceWidthBits out.issl``
    — argument order of the reference binary (isslCreateIndex.cpp:135)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("offtarget_sites")
    parser.add_argument("seq_length", type=int)
    parser.add_argument("slice_width_bits", type=int)
    parser.add_argument("output")
    parser.add_argument("--threads", type=int, default=None,
                        help="ingest worker threads (default: all cores)")
    args = parser.parse_args(argv)

    from ..index import save_native, write_reference_issl
    from ..index.stream import build_index_from_sites_text

    index = build_index_from_sites_text(
        args.offtarget_sites, seq_length=args.seq_length,
        slice_width=args.slice_width_bits, threads=args.threads)
    # output format by suffix: .npz -> compressed native; .isslx or a
    # trailing separator -> memmapped native directory; anything else ->
    # the reference .issl binary layout
    if args.output.endswith(".npz"):
        save_native(index, args.output)
    elif args.output.endswith(".isslx") or args.output.endswith(os.sep):
        save_native(index, args.output.rstrip(os.sep))
    else:
        write_reference_issl(index, args.output)
    print("Done.")


def main_score_offtargets(argv=None):
    """``scoreOfftargets issltable queries.txt maxDist threshold method``
    — same CLI and stdout format as isslScoreOfftargets
    (isslScoreOfftargets.cpp:94,514-527).

    Scores with the general exact engine (``ops/issl_flat.py``) and its
    early-exit emulation, as the JAX CLI does: every query carries the
    binary's scores, early-exited ones included. Device and precision
    follow the JAX CLI's rule on the estimated scan work
    (``device.score_offtargets_placement``): a small workload scores in
    f64 on the GPU, a large one in TwoSum-compensated f32;
    ``CRACKLING_PLATFORM=cpu`` scores in f64 on the CPU."""
    parser = argparse.ArgumentParser()
    parser.add_argument("issltable")
    parser.add_argument("queryfile")
    parser.add_argument("max_dist", type=int)
    parser.add_argument("threshold", type=float)
    parser.add_argument("method",
                        choices=["mit", "cfd", "and", "or", "avg"])
    args = parser.parse_args(argv)

    from ..codec import strings_to_sigs
    from ..index import load_native, read_reference_issl
    from ..ops.issl_flat import IsslScorer

    if args.issltable.endswith(".npz") or os.path.isdir(args.issltable):
        index = load_native(args.issltable)
    else:
        index, _ = read_reference_issl(args.issltable)
    with open(args.queryfile) as fp:
        seqs = fp.read().split()
    sigs = strings_to_sigs(seqs, index.seq_length)
    est = len(seqs) * index.slice_count * (index.num_sites
                                           / index.bucket_count)
    device, dtype = score_offtargets_placement(est)
    scorer = IsslScorer(index, max_dist=args.max_dist, method=args.method,
                        threshold=args.threshold, dtype=dtype,
                        device=device)
    mit, cfd = scorer.score(sigs)
    calc_mit = args.method in ("mit", "and", "or", "avg")
    calc_cfd = args.method in ("cfd", "and", "or", "avg")
    out = []
    for s, m, c in zip(seqs, mit, cfd):
        m_s = "%f" % m if calc_mit else "-1"
        c_s = "%f" % c if calc_cfd else "-1"
        out.append(f"{s}\t{m_s}\t{c_s}\n")
    sys.stdout.write("".join(out))


def main_train_model(argv=None):
    """``trainModel`` (reference trainModel.py): retrains the sgRNAScorer
    2.0 SVM, by default from the shipped data."""
    from ..sgrnascorer import main_train

    main_train(argv)


def main_count_hit_transcripts(argv=None):
    """``countHitTranscripts`` (reference countHitTranscripts.py): counts
    the annotated transcripts each guide of a Crackling CSV hits."""
    from ..pipeline.transcripts import main as transcripts_main

    transcripts_main(argv)
