"""The port's launchers (dagnn_tpu_torch/scripts/*.sh) against the JAX
package's (scripts/*.sh), and run for real on the CPU.

Argument parity: a stub `python`, first on PATH, writes the cwd and argv
of each call to a file, so no Python module is imported. Each protocol
script of both packages runs under the same environments (the defaults;
the data variables set; CKPT set; widths overridden; extra arguments;
started by a relative path from another directory), and the calls must
be equal but for the module prefix (dagnn_tpu. -> dagnn_tpu_torch.) and
the port's default result directories (results/torch_*, so that a run of
the port never writes into the JAX package's committed records). The
data path must name the same file, and the cwd is the repo root. JAX's
na_train.sh resolves its default DATA from $0 after its cd, so started
by a relative path from another directory it names a file that is not
the corpus: that case is an expected failure, kept so the quirk stays
recorded. run_tests.sh collects the port's test files and no other.

For real: the NA chain (na_train.sh, na_eval.sh with CKPT, then
summarize) and one epoch of one fold of ogb_tok.sh and ogb_lp.sh, with
--cpu and small flags: exit code 0, the files each writes, finite
numbers.
"""

import csv
import glob
import gzip
import math
import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR, PORT_DIR = "scripts", os.path.join("dagnn_tpu_torch", "scripts")
PROTOCOLS = ("ogb_tok", "ogb_lp", "na_train", "na_eval", "bn_train", "bn_eval")
# the JAX scripts' default result directories and the port's
RESULT_DIRS = {"results/torch_na": "results/na", "results/torch_bo": "results/bo",
               "results/torch_bn": "results/bn",
               "results/torch_bo_bn": "results/bo_bn"}
PORT_RES = {"na_train": "results/torch_na", "na_eval": "results/torch_bo",
            "bn_train": "results/torch_bn", "bn_eval": "results/torch_bo_bn"}
CORPUS = os.path.join(REPO, "data", "final_structures6.txt.gz")
# every variable a launcher reads, cleared from the inherited environment
VARS = ("DATA_ROOT", "TRAIN_IDX", "BS", "LR", "CLIP", "FOLDS", "PATIENCE", "EMB",
        "LAYERS", "AGG", "BIDIR", "POOL", "EPOCHS", "HS", "NZ", "SAVE_INTERVAL",
        "RES", "DATA", "CKPT", "SEEDS", "ROUNDS")

STUB = """#!/usr/bin/env bash
n=$(ls "$STUB_OUT" | wc -l)
printf '%s\\0' "$PWD" "${JAX_PLATFORMS-}" "$@" > "$STUB_OUT/$n"
"""

CASES = {
    "defaults": ({}, []),
    "data": ({"DATA_ROOT": "/data/ogbg_code2", "TRAIN_IDX": "/data/train15.csv.gz",
              "DATA": "/data/corpus.txt"}, []),
    "ckpt": ({"CKPT": "results/x/DAGNN_0_100.ckpt", "SEEDS": "3", "ROUNDS": "2"}, []),
    "widths": ({"HS": "64", "NZ": "8", "BS": "16", "EPOCHS": "3", "LR": "1e-3",
                "SAVE_INTERVAL": "1", "EMB": "128", "LAYERS": "3", "AGG": "gated_sum",
                "BIDIR": "0", "POOL": "mean", "FOLDS": "2", "PATIENCE": "3",
                "CLIP": "0.5", "RES": "results/mine"}, []),
    "extra": ({"CKPT": "results/x/DAGNN_0_100.ckpt"}, ["--cpu", "--seed", "7"]),
    "relative": ({}, []),
}


def _positional(script, case):
    """The positional arguments: a latent for the eval scripts, a model
    for the train scripts in the extra-arguments case."""
    if script.endswith("_eval"):
        return ["results/x/latent_epoch100.mat"]
    if case == "extra" and script.endswith("_train"):
        return ["DVAE"]
    return []


def _calls(tmp_path, directory, script, env_vars, args, cwd=REPO):
    """[(cwd, JAX_PLATFORMS, argv)] of every `python` the script starts."""
    stub_dir, out = tmp_path / "bin", tmp_path / f"out_{directory.replace('/', '_')}"
    stub_dir.mkdir(exist_ok=True)
    (stub_dir / "python").write_text(STUB)
    (stub_dir / "python").chmod(0o755)
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in VARS + ("JAX_PLATFORMS",)}
    env.update(env_vars, PATH=f"{stub_dir}:{env['PATH']}", STUB_OUT=str(out))
    path = os.path.join(REPO, directory, f"{script}.sh")
    if cwd != REPO:
        path = os.path.relpath(path, cwd)
    r = subprocess.run(["bash", path, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    calls = []
    for f in sorted(os.listdir(out), key=int):
        here, platforms, *argv = (out / f).read_bytes().decode().split("\0")[:-1]
        calls.append((here, platforms, argv))
    return calls


def _normal(calls, port):
    """The calls with the data path resolved against the call's cwd and,
    for the port, the module prefix and default result directories put
    back to the JAX package's."""
    out = []
    for here, platforms, argv in calls:
        argv = list(argv)
        for i, a in enumerate(argv[:-1]):
            if a == "--data-path":
                argv[i + 1] = os.path.realpath(os.path.join(here, argv[i + 1]))
            if port and a in ("--res_dir",) and argv[i + 1] in RESULT_DIRS:
                argv[i + 1] = RESULT_DIRS[argv[i + 1]]
        if port:
            argv = [a.replace("dagnn_tpu_torch.", "dagnn_tpu.", 1) if a.startswith(
                "dagnn_tpu_torch.cli.") else a for a in argv]
        out.append((os.path.realpath(here), platforms, argv))
    return out


def _run_both(tmp_path, script, case):
    env_vars, extra = CASES[case]
    args = _positional(script, case) + extra
    cwd = os.path.join(REPO, "tests") if case == "relative" else REPO
    return (_calls(tmp_path, JAX_DIR, script, env_vars, args, cwd),
            _calls(tmp_path, PORT_DIR, script, env_vars, args, cwd))


def _parity_params():
    quirk = pytest.mark.xfail(
        strict=True, reason="JAX's na_train.sh resolves its default DATA from "
        "$0 after its cd, so a relative start from another directory names "
        "another file")
    return [pytest.param(s, c, marks=quirk if (s, c) == ("na_train", "relative")
                         else ()) for s in PROTOCOLS for c in CASES]


@pytest.mark.parametrize("script,case", _parity_params())
def test_launcher_passes_the_jax_scripts_arguments(tmp_path, script, case):
    jax_calls, port_calls = _run_both(tmp_path, script, case)
    assert len(jax_calls) == len(port_calls) >= 1
    assert _normal(port_calls, port=True) == _normal(jax_calls, port=False)


@pytest.mark.parametrize("script", PROTOCOLS)
@pytest.mark.parametrize("case", list(CASES))
def test_port_launcher_paths(tmp_path, script, case):
    """The port's side alone: the repo root as cwd, its own CLIs, the
    corpus found from any directory, its own result directories, the
    card unless --cpu is passed."""
    env_vars, extra = CASES[case]
    cwd = os.path.join(REPO, "tests") if case == "relative" else REPO
    calls = _calls(tmp_path, PORT_DIR, script, env_vars,
                   _positional(script, case) + extra, cwd)
    for here, _, argv in calls:
        assert os.path.realpath(here) == os.path.realpath(REPO)
        assert argv[:2] == ["-m", argv[1]] and argv[1].startswith(
            "dagnn_tpu_torch.cli.")
        cpu = "--cpu" in extra and not argv[1].endswith(".summarize")
        assert ("--cpu" in argv) == cpu
        if "--data-path" in argv:
            got = argv[argv.index("--data-path") + 1]
            want = env_vars.get("DATA", CORPUS)
            assert os.path.realpath(os.path.join(here, got)) == os.path.realpath(want)
        if script in PORT_RES:
            assert argv[argv.index("--res_dir") + 1] == env_vars.get(
                "RES", PORT_RES[script])
    if script == "na_train":
        assert "--data-path" in calls[0][2]


def test_run_tests_collects_the_port_suite(tmp_path):
    calls = _calls(tmp_path, PORT_DIR, "run_tests", {}, ["-n", "4"],
                   os.path.join(REPO, "tests"))
    assert len(calls) == 1
    here, platforms, argv = calls[0]
    assert os.path.realpath(here) == os.path.realpath(REPO)
    assert platforms == "cpu" and argv[:2] == ["-m", "pytest"]
    files = [a for a in argv if a.startswith("tests/")]
    want = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*.py")))
    assert files == want and "tests/test_torch_launchers.py" in files
    assert argv[-2:] == ["-n", "4"]


# ------------------------------------------------------- real CPU runs

def _launch(script, env_vars, args, timeout=300):
    """The port's launcher run for real, one CPU thread a process (the
    suite's workers share the machine)."""
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    env.update(env_vars, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run(["bash", os.path.join(REPO, PORT_DIR, f"{script}.sh"),
                        *args], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def _finite_rows(path, skip_header=True):
    with open(path) as f:
        rows = list(csv.reader(f))[1 if skip_header else 0:]
    assert rows, path
    for row in rows:
        assert all(math.isfinite(float(v)) for v in row if v.strip()), row
    return rows


def test_na_chain_runs_on_the_cpu(tmp_path):
    """108 train graphs in batches of 32: three full batches and a tail of
    12 an epoch, each one step of the captured train step (staged, on the
    CPU). The BO round's surrogate learns from 600 graphs of the corpus."""
    na, bo = tmp_path / "na", tmp_path / "bo"
    out = _launch("na_train", {"RES": str(na), "EPOCHS": "2", "SAVE_INTERVAL": "1",
                               "HS": "16", "NZ": "6"},
                  ["DAGNN", "--cpu", "--max-count", "120"])
    assert "on cpu" in out
    assert "captured train step (captures / replays) this run: 2 / 8" in out
    rows = _finite_rows(na / "train_loss.txt")
    assert [int(r[0]) for r in rows] == [1, 2]
    nll = float(re.search(r"recon loss: (\S+)", (na / "test_results.txt").read_text())[1])
    assert math.isfinite(nll)
    for name in ("DAGNN_0_2.ckpt", "final_structures6_latent_epoch2.mat"):
        assert (na / name).exists(), name
    corpus = tmp_path / "corpus.txt.gz"
    with gzip.open(CORPUS, "rt") as f, gzip.open(corpus, "wt") as g:
        g.writelines(line for _, line in zip(range(600), f))
    out = _launch("na_eval", {"RES": str(bo), "CKPT": str(na / "DAGNN_0_2.ckpt"),
                              "SEEDS": "1", "ROUNDS": "1"},
                  [str(na / "final_structures6_latent_epoch2.mat"), "--cpu",
                   "--M", "10", "--gp-iters", "3", "--hs", "16", "--nz", "6",
                   "--refine-iters", "1", "--enas-corpus", str(corpus)])
    rmse = re.findall(r"Test RMSE: (\S+), ll: (\S+), Pearson r: (\S+)",
                      (bo / "Test_RMSE_ll.txt").read_text())
    assert len(rmse) == 1 and all(math.isfinite(float(v)) for v in rmse[0])
    assert (bo / "best_arc_scores.txt").read_text().strip()
    assert "1 seeds" in out and "best architecture scores:" in out


@pytest.mark.parametrize("script,csvs", [
    ("ogb_tok", ("dagnn_tok.csv", "dagnn_tok_train.csv")),
    ("ogb_lp", ("dagnn_lp.csv", "dagnn_lp_train.csv"))])
def test_ogb_launcher_runs_on_the_cpu(tmp_path, script, csvs):
    res, save = tmp_path / "results", tmp_path / "saved"
    _launch(script, {"EPOCHS": "1", "FOLDS": "1", "BS": "20", "EMB": "16",
                     "LAYERS": "1"},
            ["--cpu", "--synthetic", "60", "--smoke", "--synthetic_mean_nodes",
             "12", "--num_vocab", "50", "--dir_results", str(res),
             "--dir_save", str(save)])
    for name in csvs:
        _finite_rows(res / name)


def test_protocol_report_reads_both_packages_records():
    """scripts/protocol_report on the committed records of the NA protocol
    (the port's under results/torch_*, JAX's under results/na and
    results/bo_enas_bo): one row a tenth epoch, the test loss, both seeds'
    means, the BO rows; the times from the stamped logs."""
    from dagnn_tpu_torch.scripts import protocol_report as pr
    args = pr.parse_args(["--port", os.path.join(REPO, "results", "torch_na"),
                          "--port-bo", os.path.join(REPO, "results", "torch_bo_enas_bo"),
                          "--jax", os.path.join(REPO, "results", "na"),
                          "--jax-bo", os.path.join(REPO, "results", "bo_enas_bo")])
    rows, met = pr.report(args)
    assert set(met) == {*(f"loss_{e}" for e in range(10, 101, 10)), "test_recon",
                        "Pearson r", "RMSE", "valid_rounds"}
    assert len(rows) == 2 + 10 + 1 + 2 + 2
    assert "| 0.7496 |" in rows[-1]
    times = pr.times(args.port, args.port_bo)
    assert [t.split(":")[0] for t in times] == [
        "- epoch seconds", "- a latent extraction (train and test graphs)",
        "- a BO round", "- a seed's GP fit and scoring (from its last round's line)"]
