"""The NA VAE's training curve, the JAX driver's against the port's, on the
CPU (a check run by hand, not collected by pytest: at hs 501 it takes
minutes).

Both drivers train 6 epochs on the corpus's first 1,100 rows (990 train
graphs) with the same flags, the port from the JAX init (as the test
suite's parity tests do), so that only the two packages' noise streams
differ. Prints each epoch's (loss, recon, kld) of both and their ratio,
and exits non-zero where an epoch's loss is not within RTOL of JAX's.

    JAX_PLATFORMS=cpu python tests/na_curve_check.py --hs 501
"""

import argparse
import csv
import dataclasses
import os
import sys
import tempfile

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dagnn_tpu.cli import train_vae as jdriver  # noqa: E402
from dagnn_tpu.vae import dagnn_vae as jvae  # noqa: E402
from dagnn_tpu_torch import convert  # noqa: E402
from dagnn_tpu_torch.cli import train_vae as tdriver  # noqa: E402

# Each epoch's mean loss of the port within this of JAX's, relative, at the
# default hs 64: the two drivers differ only in their noise streams (read
# 4e-4 over 6 epochs on 990 graphs on the CPU). A wider model parts further
# (1.3e-2 at hs 501), so the exit code holds the default width only.
# tests/test_torch_bo_trained.py holds the curve across a plateau drop to
# this bound.
RTOL = 1e-3


def _rows(res_dir):
    with open(os.path.join(res_dir, "train_loss.txt")) as f:
        return [[float(v) for v in r[1:]] for r in list(csv.reader(f))[1:]]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hs", default="64")
    args = p.parse_args(argv)
    torch.set_num_threads(4)

    def init(self, seed):
        cfg = jvae.DAGNNVAEConfig(**dataclasses.asdict(self.cfg))
        tree = jvae.dagnn_vae_init(jax.random.PRNGKey(seed), cfg)
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree), self.device)

    tdriver.VAEModel.init = init
    flags = ["--max-count", "1100", "--hs", args.hs, "--nz", "16", "--epochs", "6",
             "--save-interval", "100", "--no-test", "--cpu"]
    with tempfile.TemporaryDirectory() as root:
        jdriver.main(flags + ["--res_dir", os.path.join(root, "jax")])
        tdriver.main(flags + ["--res_dir", os.path.join(root, "port")])
        worst = 0.0
        for e, (j, t) in enumerate(zip(_rows(os.path.join(root, "jax")),
                                       _rows(os.path.join(root, "port"))), 1):
            print(f"epoch {e}: JAX {[round(v, 4) for v in j]}, port "
                  f"{[round(v, 4) for v in t]}, loss port / JAX {t[0] / j[0]:.4f}")
            worst = max(worst, abs(t[0] / j[0] - 1))
    print(f"largest relative difference {worst:.2e} (limit {RTOL:.0e} at hs 64)")
    return worst <= RTOL or args.hs != "64"


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
