"""Drop-in shim binaries for the reference pipeline's external tools.

The reference Crackling shells out to three executables: the ISSL scorer
(covered by the argv/stdout-compatible ``scoreOfftargets`` CLI,
utils/cli.py), ``RNAfold`` (Crackling.py:426-435) and ``bowtie2``
(Crackling.py:648-658). These shims speak the exact command lines and
output formats those call sites rely on, backed by this package's engines:

* RNAfold shim — ``RNAfold --noPS -j{n} -i {input} -o``: folds each
  input line with the native C++ Zuker engine (ops/rna_params model), or,
  where the native library is unavailable, with the batched fold of
  ops/mfe.py on the CLIs' device (the GPU unless CRACKLING_PLATFORM=cpu),
  and writes ``RNAfold_output.fold`` in the CWD as alternating sequence
  (T->U, as RNAfold echoes) / ``structure (energy)`` lines. It names the
  engine that folded on stderr.
* bowtie2 shim — ``bowtie2 -x {fasta} -p {n} --reorder --no-hd -t -r
  -U {input} -S {output}``: emulated-Bowtie2 positioning
  (pipeline/positioning.best_alignment — the same code path the pipeline
  uses, so reference+shim and this pipeline agree exactly). Emits
  headerless SAM with the fields/tags the reference parses: RNAME, POS,
  SEQ, ``XM:i:0`` iff the read has a perfect alignment and ``XS:i:0`` iff
  a second perfect alignment exists.

:func:`write_shim_scripts` materializes them as executable scripts so the
reference ConfigManager's ``shutil.which`` validation passes.
"""

from __future__ import annotations

import os
import stat
import sys
from pathlib import Path

import numpy as np


def rnafold_main(argv: list[str]) -> int:
    """Entry point for the RNAfold shim."""
    inp = None
    for i, a in enumerate(argv):
        if a == "-i":
            inp = argv[i + 1]
    if inp is None:
        print("rnafold shim: missing -i <input>", file=sys.stderr)
        return 2
    seqs = [l.strip() for l in open(inp) if l.strip()]

    from ..device import cli_device
    from ..pipeline.secondary_structure import (fold_constructs_native,
                                                fold_constructs_tpu)

    try:
        l2 = fold_constructs_native(seqs)
        engine = "native"
    except RuntimeError:
        device = cli_device()
        l2 = fold_constructs_tpu(seqs, device)
        engine = f"batched DP on {device}"
    print(f"rnafold shim: folded {len(seqs)} sequences with the {engine} "
          f"engine", file=sys.stderr)
    with open("RNAfold_output.fold", "w") as fp:
        for s, line2 in zip(seqs, l2):
            fp.write(s.upper().replace("T", "U") + "\n")
            fp.write(line2 + "\n")
    return 0


def bowtie2_main(argv: list[str]) -> int:
    """Entry point for the bowtie2 shim."""
    args = {}
    for i, a in enumerate(argv):
        if a in ("-x", "-U", "-S", "-p") and i + 1 < len(argv):
            args[a] = argv[i + 1]
    if "-x" not in args or "-U" not in args or "-S" not in args:
        print("bowtie2 shim: need -x/-U/-S", file=sys.stderr)
        return 2

    from ..codec import strings_to_sigs
    from ..pipeline.positioning import (GenomeIndex, best_alignment,
                                        rc_sig23, window_range)

    reads = [l.strip() for l in open(args["-U"]) if l.strip()]
    genome = GenomeIndex.from_fasta(args["-x"])
    sigs = strings_to_sigs(reads, 23)
    pos, dist = best_alignment(sigs, genome, max_mm=2)

    # perfect-alignment counts for XM/XS (both strands)
    win_sigs, win_pos = genome.window_index()

    def exact_count(keys):
        return window_range(win_sigs, win_pos, keys)[0]

    n_exact = exact_count(sigs) + exact_count(rc_sig23(sigs))

    NOPOS = np.iinfo(np.int64).max
    with open(args["-S"], "w") as fp:
        for k, read in enumerate(reads):
            if pos[k] == NOPOS:
                fields = [str(k), "4", "*", "0", "0", "*", "*", "0", "0",
                          read, "I" * len(read), "YT:Z:UU"]
            else:
                rec, p1 = genome.locate(np.array([pos[k]]))
                tags = [f"XM:i:{int(dist[k])}", "MD:Z:23", "YT:Z:UU"]
                if dist[k] == 0 and n_exact[k] >= 2:
                    tags.insert(0, "XS:i:0")
                fields = [str(k), "0", genome.names[rec[0]], str(int(p1[0])),
                          "42", "23M", "*", "0", "0", read,
                          "I" * len(read)] + tags
            fp.write("\t".join(fields) + "\n")
    return 0


_SHIM_TEMPLATE = """#!{python}
import sys
sys.path.insert(0, {repo!r})
from crackling_tpu_torch.utils.shims import {main}
sys.exit({main}(sys.argv[1:]))
"""


def write_shim_scripts(dst_dir: str) -> dict[str, str]:
    """Write executable RNAfold/bowtie2 shim scripts into ``dst_dir``.
    Returns {'rnafold': path, 'bowtie2': path}."""
    repo = str(Path(__file__).resolve().parents[2])
    out = {}
    for name, main in (("rnafold", "rnafold_main"),
                       ("bowtie2", "bowtie2_main")):
        path = os.path.join(dst_dir, f"{name}-shim")
        with open(path, "w") as fp:
            fp.write(_SHIM_TEMPLATE.format(python=sys.executable,
                                           repo=repo, main=main))
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
                 | stat.S_IXOTH)
        out[name] = path
    return out
