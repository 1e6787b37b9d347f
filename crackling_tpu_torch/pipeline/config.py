"""INI-compatible configuration manager.

Accepts the reference's config.ini format unchanged
(/root/reference/src/crackling/ConfigManager.py, config.ini): the same
sections (general/consensus/input/output/offtargetscore/sgrnascorer2/
bowtie2/rnafold) and keys, so an existing Crackling config drives this
framework. Differences:

* external binaries (RNAfold, Bowtie2, isslScoreOfftargets) are not
  required — the equivalents are in-process. ``offtargetscore.binary`` etc.
  are accepted and ignored unless a subprocess backend is selected;
* ``input.offtarget-sites`` may point at a sorted site list (text), a
  reference ``.issl`` index, or a native ``.npz`` index;
* new optional keys live in the ``[tpu]`` section (device, query-block,
  engine = auto|dense|exact|mxu|pallas|xla|sharded) and
  ``[output] resume`` for batch-granular resume.
"""

from __future__ import annotations

import configparser
import glob
import os
from time import localtime, strftime


class ConfigManager:
    """Load + validate a Crackling-style INI config.

    Mirrors the reference surface: ``cm['section']['key']`` access,
    ``getIterFilesToProcess``, ``getLogMethod`` etc.
    (ConfigManager.py:33,219-262).
    """

    def __init__(self, file_path, messenger=print):
        self._config_file_path = str(file_path)
        self._fallback_name = strftime("%Y%m%d%H%M%S", localtime())
        self._files_to_process: list[str] = []
        self._parser = configparser.ConfigParser(interpolation=None)
        self._send_msg = messenger
        self._is_configured = self._load() and self._validate()
        if self._is_configured:
            self._create_list_of_files()

    # -- reference-compatible camelCase surface -------------------------

    def __getitem__(self, key):
        return self._parser[key]

    def isConfigured(self):
        return self._is_configured

    def getConfigName(self):
        return self._parser["general"]["name"] or self._fallback_name

    def getNumberToolsInConsensus(self):
        c = self._parser["consensus"]
        return sum(
            c.getboolean(k) for k in ("mm10db", "sgrnascorer2", "chopchop")
        )

    def getDatasetSizeBytes(self):
        return sum(os.path.getsize(x) for x in self._files_to_process)

    def getIterFilesToProcess(self):
        """Yield input files, deriving per-file temp paths exactly like the
        reference (ConfigManager.py:219-238) for auxiliary outputs."""
        c = self._parser
        name = self.getConfigName()
        out_dir = c["output"]["dir"]
        for file_id, f in enumerate(self._files_to_process):
            c["rnafold"]["input"] = os.path.join(out_dir, f"{name}-rnafold-input.txt")
            c["rnafold"]["output"] = os.path.join(out_dir, f"{name}-rnafold-output.txt")
            c["offtargetscore"]["input"] = os.path.join(
                out_dir, f"{name}-{file_id}-offtargetscore-input.txt")
            c["offtargetscore"]["output"] = os.path.join(
                out_dir, f"{name}-{file_id}-offtargetscore-output.txt")
            c["bowtie2"]["input"] = os.path.join(out_dir, f"{name}-bowtie-input.txt")
            c["bowtie2"]["output"] = os.path.join(out_dir, f"{name}-bowtie-output.txt")
            yield f

    def getLogMethod(self):
        from .logger import Logger

        return Logger(os.path.join(
            self._parser["output"]["dir"],
            "{}-{}.log".format(self._parser["general"]["name"], self.getConfigName()),
        ))

    def getErrLogMethod(self):
        from .logger import Logger

        return Logger(os.path.join(
            self._parser["output"]["dir"],
            "{}-{}.errlog".format(self._parser["general"]["name"], self.getConfigName()),
        ))

    # -- internals ------------------------------------------------------

    def _load(self) -> bool:
        # v1.0.0 configs are Python modules holding a CONFIG dict, passed
        # without a file extension (ConfigManager.py:39-56); migrate them
        # to the INI format exactly like the reference
        _, ext = os.path.splitext(self._config_file_path)
        loaded = ext == "" and self._v1_0_0_to_v1_1_0()
        if not loaded:
            try:
                with open(self._config_file_path, "r") as fp:
                    self._parser.read_file(fp)
            except Exception as e:
                self._send_msg(f"Could not read config: {e}")
                return False
        # defaults for sections the reference config may omit
        if not self._parser.has_section("tpu"):
            self._parser.add_section("tpu")
        return True

    def _v1_0_0_to_v1_1_0(self) -> bool:
        """Migrate a v1.0.0 dict-config (reference
        ConfigManager.py:58-134): import the module, fill the consensus
        tool switches the old format lacked, validate the required keys,
        convert to INI sections, and write the ``<path>.ini`` copy."""
        try:
            import importlib

            lib = importlib.import_module(self._config_file_path)
            config = lib.CONFIG
        except Exception:
            self._send_msg("Yikes!!")
            return False

        if {"mm10db", "sgRNAScorer2", "CHOPCHOP"} != config["consensus"].keys():
            config["consensus"]["mm10db"] = True
            config["consensus"]["sgRNAScorer2"] = True
            config["consensus"]["CHOPCHOP"] = True

            required = [
                ("consensus", "n"), ("input", "exon-sequences"),
                ("input", "offtarget-sites"), ("input", "gff-annotation"),
                ("input", "bowtie2-index"), ("output", "dir"),
                ("output", "fileName"), ("output", "delimiter"),
                ("offtargetscore", "binary"), ("offtargetscore", "threads"),
                ("offtargetscore", "score-threshold"),
                ("offtargetscore", "max-distance"),
                ("sgrnascorer2", "model"), ("sgrnascorer2", "score-threshold"),
                ("bowtie2", "binary"), ("bowtie2", "threads"),
                ("rnafold", "binary"), ("rnafold", "threads"),
                ("rnafold", "low_energy_threshold"),
                ("rnafold", "high_energy_threshold"),
            ]
            ok = "name" in config and all(
                s in config and k in config[s] for s, k in required)
            if not ok:
                self._send_msg(
                    "Your v1.0.0 configuration is invalid. We suggest "
                    "updating to the new format, defined as per v1.1.0. See "
                    "the GitHub repository for a sample configuration file. "
                    "https://github.com/bmds-lab/Crackling")
                return False

            self._parser.add_section("general")
            for first in config:
                if isinstance(config[first], dict):
                    self._parser.add_section(first)
                    for second in config[first]:
                        self._parser.set(first, second,
                                         str(config[first][second]))
                else:
                    self._parser.set("general", first, config[first])

            new_name = f"{self._config_file_path}.ini"
            self._send_msg("We have transformed your configuration file "
                           f"into the new format. See {new_name}")
            with open(new_name, "w+") as fp:
                self._parser.write(fp)
        return True

    def _validate(self) -> bool:
        c = self._parser
        passed = True

        n = int(c["consensus"]["n"])
        n_tools = self.getNumberToolsInConsensus()
        if n > n_tools:
            passed = False
            self._send_msg(
                f"The consensus approach is incorrectly set. You have specified "
                f"{n_tools} tools but the n-value is {n}."
            )

        c["output"]["file"] = os.path.join(
            c["output"]["dir"], f"{self.getConfigName()}-{c['output']['fileName']}"
        )
        resume = c["output"].getboolean("resume", fallback=False)
        if os.path.exists(c["output"]["file"]) and not resume:
            passed = False
            self._send_msg(f"The output file already exists: {c['output']['file']}")
            self._send_msg("To avoid losing data, please rename your output file "
                           "(or set [output] resume = True).")
        return passed

    def _create_list_of_files(self):
        src = self._parser["input"]["exon-sequences"]
        if os.path.isdir(src):
            for root, dirs, files in os.walk(src):
                for f in sorted(files, reverse=True):
                    self._files_to_process.append(os.path.join(src, f))
        elif os.path.isfile(src):
            self._files_to_process = [src]
        else:
            self._files_to_process = glob.glob(src)
