"""ogbg-code2 LP driver: classify the longest-path length of the AST DAG.

Counterpart of dagnn_tpu/cli/main_lp.py (reference: ogbg-code/
main_pyg_lp.py): 275-way classification of len_longest_path, accuracy
metric, DAGNN defaults gated_sum / unidirectional (main_pyg_lp.py:
140-148). Runs on the CUDA device; --cpu runs on the CPU:

    python -m dagnn_tpu_torch.cli.main_lp --synthetic 300 --epochs 3 --smoke --cpu
    python -m dagnn_tpu_torch.cli.main_lp --synthetic 300 --epochs 3 --smoke
"""

import argparse

from dagnn_tpu_torch.cli.ogb_driver import add_common_args, run


def parser():
    """The driver's argument parser: the common flags, with the LP
    defaults."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.set_defaults(dagnn_agg="gated_sum", dagnn_bidir=0)
    return p


def main(argv=None):
    """Parse `argv` (sys.argv[1:] when None) and train; returns each
    fold's best {epoch, train, valid, test}."""
    return run(parser().parse_args(argv), task="lp")


if __name__ == "__main__":
    main()
