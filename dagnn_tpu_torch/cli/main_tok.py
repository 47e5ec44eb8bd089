"""ogbg-code2 TOK driver: predict 5 sub-tokens of a Python function name.

Counterpart of dagnn_tpu/cli/main_tok.py (reference: ogbg-code/main_pyg.py),
metric = per-sample set F1. Runs on the CUDA device; --cpu runs on the CPU:

    python -m dagnn_tpu_torch.cli.main_tok --synthetic 300 --epochs 3 --smoke --cpu
    python -m dagnn_tpu_torch.cli.main_tok --synthetic 300 --epochs 3 --smoke
    python -m dagnn_tpu_torch.cli.main_tok --data_root /path/to/ogbg_code2 \
        --train_idx /path/to/train15.csv.gz
"""

import argparse

from dagnn_tpu_torch.cli.ogb_driver import add_common_args, run


def main(argv=None):
    """Parse `argv` (sys.argv[1:] when None) and train; returns each
    fold's best {epoch, train, valid, test}."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    args = p.parse_args(argv)
    return run(args, task="tok")


if __name__ == "__main__":
    main()
