"""Uninstalled CLI dispatcher:
``python -m crackling_tpu_torch.utils.run_cli <command> [args...]``

Maps command names to the console entry points in ``cli.py`` so the tools
work without pip-installing the package.
"""

import sys

from . import cli

COMMANDS = {
    "Crackling": cli.main_crackling,
    "extractOfftargets": cli.main_extract_offtargets,
    "createIsslIndex": cli.main_create_issl_index,
    "scoreOfftargets": cli.main_score_offtargets,
    "trainModel": cli.main_train_model,
    "countHitTranscripts": cli.main_count_hit_transcripts,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(f"usage: {sys.argv[0]} {{{'|'.join(COMMANDS)}}} [args...]",
              file=sys.stderr)
        sys.exit(2)
    COMMANDS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    main()
