"""mm10db secondary-structure gate (RNAfold-equivalent).

The reference folds ``'G' + target23[1:20] + scaffold`` with the RNAfold
binary and gates on a canonical-structure regex plus energy thresholds
(/root/reference/src/crackling/Crackling.py:389-507). This module keeps the
exact decision logic and record fields (ssL1/ssStructure/ssEnergy, the
CODE_ERROR case for targets starting with T, the two thresholds) while
making the folding engine pluggable:

* ``vienna`` — drives the RNAfold binary exactly like the reference
  (parity backend; used automatically when the binary is on PATH);
* ``native`` — the C++ Zuker engine (native/fold.cpp, OpenMP over the
  batch; RNAfold-class speed). Energy model: ops/rna_params.py —
  ViennaRNA's exact loop decomposition; with ``parameter_file`` set to a
  ViennaRNA ``rna_turner2004.par`` the tables are digit-exact, otherwise
  reconstructed defaults apply (see the provenance notes in rna_params)
  and verdicts on this one sub-test may differ from the reference near
  the energy thresholds;
* ``tpu`` — the batched Zuker DP of ops/mfe.py in f64 on the gate's
  device (the GPU unless the caller asks for the CPU), folded in chunks
  sized to its free memory (at most 4,096 guides) and traced back on
  the host chunk by chunk; its energies
  agree with the native engine's to 1e-6 and its structures are equal.

``auto`` picks vienna > native > tpu.
"""

from __future__ import annotations

import os
import re
import shlex
import shutil
import subprocess
import tempfile

import numpy as np

from ..constants import (
    CODE_ACCEPTED,
    CODE_ERROR,
    CODE_REJECTED,
    PATTERN_RNA_ENERGY,
    PATTERN_RNA_STRUCTURE,
    SCAFFOLD_RNA,
)
from ..codec import trans_to_dna


def fold_constructs_vienna(rna_inputs: list[str], binary: str, threads: int,
                           workdir: str | None = None,
                           param_file: str | None = None) -> list[str]:
    """Fold with the RNAfold binary; returns raw L2 lines
    ('structure (energy)') in input order, replicating the reference
    invocation ``RNAfold --noPS -j{threads} -i {in} -o``
    (Crackling.py:426-435). ``param_file`` adds ``-P <file>`` so the
    binary and the in-process engines run the same parameter set."""
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        inp = os.path.join(td, "rnafold-input.txt")
        with open(inp, "w") as fp:
            fp.write("".join(s + "\n" for s in rna_inputs))
        # the reference runs the command through a shell
        # (Helpers.py:39-42), so configs may carry arguments or a wrapper
        # in the binary value ("nice -n 19 RNAfold"); shlex-split keeps
        # those working without handing the whole line to a shell
        argv = shlex.split(binary) + ["--noPS", f"-j{threads}", "-i", inp,
                                      "-o"]
        if param_file:
            argv += ["-P", os.path.abspath(param_file)]
        subprocess.run(argv, check=True, cwd=td)
        out = os.path.join(td, "RNAfold_output.fold")
        lines = open(out).read().rstrip("\n").split("\n")
    # output alternates sequence line / structure+energy line
    return [lines[i] for i in range(1, len(lines), 2)]


def fold_constructs_tpu(rna_inputs: list[str], device=None) -> list[str]:
    """Fold with the batched MFE DP on ``device`` (None: the GPU); returns
    RNAfold-style L2 lines."""
    from ..ops.mfe import fold_sequences

    structures, energies = fold_sequences(rna_inputs, device=device)
    return [f"{s} ({e:6.2f})" for s, e in zip(structures, energies)]


def fold_constructs_native(rna_inputs: list[str],
                           threads: int = 0) -> list[str]:
    """Fold with the C++ Zuker engine; returns RNAfold-style L2 lines.
    Raises RuntimeError when the native library is unavailable."""
    from ..native import fold_batch_native
    from ..ops.mfe import encode_rna

    codes = np.stack([encode_rna(s) for s in rna_inputs])
    out = fold_batch_native(codes, nthreads=threads)
    if out is None:
        raise RuntimeError("native fold library unavailable")
    structures, energies = out
    return [f"{s} ({e:6.2f})" for s, e in zip(structures, energies)]


def _native_available() -> bool:
    from ..native import get_lib

    return get_lib() is not None


class SecondaryStructureGate:
    """Computes the mm10db secondary-structure verdict for target batches."""

    def __init__(self, backend: str = "auto", binary: str = "RNAfold",
                 threads: int = os.cpu_count() or 1,
                 low_energy_threshold: float = -30.0,
                 high_energy_threshold: float = -18.0,
                 parameter_file: str | None = None, device=None):
        if backend == "auto":
            if shutil.which(shlex.split(binary)[0]
                            if binary.strip() else binary):
                backend = "vienna"
            elif _native_available():
                backend = "native"
            else:
                backend = "tpu"
        if backend not in ("vienna", "native", "tpu"):
            raise ValueError(f"unknown secondary-structure backend: {backend}")
        self.backend = backend
        # the tpu backend's device (None: the GPU)
        self.device = device
        self.binary = binary
        self.threads = threads
        self.low = low_energy_threshold
        self.high = high_energy_threshold
        self.parameter_file = parameter_file or None
        # digit-exact Turner tables for the in-process engines; the
        # vienna backend gets the same file via RNAfold -P. Installed
        # unconditionally (None resets to defaults) so a parameter set
        # from an earlier gate in the same process never leaks in.
        from ..ops.rna_params import set_parameter_file

        set_parameter_file(self.parameter_file)
        self._pat_structure = re.compile(PATTERN_RNA_STRUCTURE)
        self._pat_energy = re.compile(PATTERN_RNA_ENERGY)

    def assess(self, targets23: list[str]):
        """Assess a page of 23-mer targets.

        Returns dict of arrays: verdict (object: 1/0/'!'), ssL1,
        ssStructure, ssEnergy (object arrays), replicating
        Crackling.py:419-498 including the RNAstructures keying by
        ``target23[1:20]`` (later duplicates of a 19-mer key win).
        """
        from ..constants import CODE_UNTESTED

        n = len(targets23)
        # guides the fold cannot judge keep their prior '?' state, exactly
        # like the reference's no-regex-match / notFound paths
        verdict = np.array([CODE_UNTESTED] * n, dtype=object)
        ss_l1 = np.array([""] * n, dtype=object)
        ss_structure = np.array([""] * n, dtype=object)
        ss_energy = np.array([""] * n, dtype=object)
        if n == 0:
            return dict(verdict=verdict, ssL1=ss_l1,
                        ssStructure=ss_structure, ssEnergy=ss_energy)

        inputs = [f"G{t[1:20]}{SCAFFOLD_RNA}" for t in targets23]
        # fold each distinct construct once
        uniq: dict[str, int] = {}
        uniq_inputs = []
        for s in inputs:
            if s not in uniq:
                uniq[s] = len(uniq_inputs)
                uniq_inputs.append(s)
        if self.backend == "vienna":
            l2_uniq = fold_constructs_vienna(uniq_inputs, self.binary,
                                             self.threads,
                                             param_file=self.parameter_file)
        elif self.backend == "native":
            l2_uniq = fold_constructs_native(uniq_inputs, self.threads)
        else:
            l2_uniq = fold_constructs_tpu(uniq_inputs, self.device)

        # reference keying: RNAstructures[transToDNA(L1[1:20])] = [L1, L2, target]
        # (Crackling.py:443-455); last write wins for duplicate keys.
        # L1 comes from the RNAfold OUTPUT, which echoes the input with
        # T -> U; store that form so the ssL1 column matches the reference.
        structures: dict[str, tuple[str, str, str]] = {}
        for s in inputs:
            l1 = s.replace("T", "U")
            l2 = l2_uniq[uniq[s]]
            target = l1[0:20]
            structures[trans_to_dna(target[1:20])] = (l1, l2, target)

        for i, t23 in enumerate(targets23):
            key = t23[1:20]
            if key not in structures:
                continue  # notFound: left untouched by the reference too
            l1, l2, target = structures[key]
            parts = l2.split(" ")
            structure = parts[0]
            energy_token = parts[1][1:-1] if len(parts) > 1 else ""
            ss_l1[i] = l1
            ss_structure[i] = structure
            ss_energy[i] = energy_token

            # the reference's mistranscription guard (Crackling.py:476-479):
            # target = 'G' + t23[1:20]; if t23 starts with T nothing matches
            # and the guide is marked CODE_ERROR.
            t20 = t23[0:20]
            if (trans_to_dna(target) != t20
                    and trans_to_dna("C" + target[1:]) != t20
                    and trans_to_dna("A" + target[1:]) != t20):
                verdict[i] = CODE_ERROR
                continue

            m = self._pat_structure.search(l2)
            if m:
                energy = float(m.group(1))
                if energy < self.low:
                    verdict[i] = CODE_REJECTED
                else:
                    verdict[i] = CODE_ACCEPTED
            else:
                m = self._pat_energy.search(l2)
                if m:
                    energy = float(m.group(1))
                    if energy <= self.high:
                        verdict[i] = CODE_REJECTED
                    else:
                        verdict[i] = CODE_ACCEPTED
        return dict(verdict=verdict, ssL1=ss_l1,
                    ssStructure=ss_structure, ssEnergy=ss_energy)
