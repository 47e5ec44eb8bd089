"""The port stands alone: it imports with jax absent (every module, the
latent scoring, the other VAEs and the parallel layer among them), none
of its modules (nor chip_smoke.py) imports the JAX package, and its entry
points run on the CUDA device unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "dagnn_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_imports_without_jax():
    mods = list(_modules())
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['optax'] = None\n"
            "sys.modules['dagnn_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")



def test_driver_runs_without_jax(tmp_path):
    """The TOK driver end to end with jax and the JAX package absent, on a
    constructed ogbg-code2 tree (Code2Dataset's npz cache, imported
    lazily by the driver) and on synthetic data: no lazy import falls
    into the JAX package."""
    from test_code2_dataset import make_raw_tree
    make_raw_tree(str(tmp_path / "ds" / "ogbg_code2"), n_graphs=9, seed=1)
    small = ["--emb_dim", "8", "--num_vocab", "6", "--batch_size", "4",
             "--chunk_size", "16", "--epochs", "1", "--folds", "1", "--cpu",
             "--dir_results", str(tmp_path / "r"), "--dir_save", str(tmp_path / "s")]
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "for m in ('jax', 'jaxlib', 'optax', 'flax', 'dagnn_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from dagnn_tpu_torch.cli import main_tok\n"
            f"main_tok.main({small!r} + ['--data_root', {str(tmp_path / 'ds')!r}])\n"
            f"main_tok.main({small!r} + ['--synthetic', '12', '--name', 'syn'])\n"
            "import dagnn_tpu_torch.data.code2_dataset\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok")
    assert (tmp_path / "ds" / "ogbg_code2" / "processed" / "data.npz").exists()
    for name in ("dagnn_tok", "syn"):
        assert (tmp_path / "r" / f"{name}_train.csv").exists()


def test_vae_driver_runs_without_jax(tmp_path):
    """The VAE driver (DAGNN on the repo's ENAS corpus, and DVAE_BN on the
    synthetic BN corpus, whose rows bn_score scores) end to end with jax
    and the JAX package absent."""
    small = ["--max-count", "20", "--hs", "8", "--nz", "4", "--batch-size", "9",
             "--epochs", "1", "--save-interval", "1", "--cpu"]
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "for m in ('jax', 'jaxlib', 'optax', 'flax', 'dagnn_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from dagnn_tpu_torch.cli import train_vae\n"
            f"train_vae.main({small!r} + ['--res_dir', 'na'])\n"
            f"train_vae.main({small!r} + ['--res_dir', 'bn', '--model', 'DVAE_BN',"
            " '--data-type', 'BN', '--nvt', '8'])\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok")
    for d in ("na", "bn"):
        assert (tmp_path / d / "final_structures6_latent_epoch1.mat").exists()


def test_latent_scoring_runs_without_jax(tmp_path):
    """The latent-scoring entry points and the other VAEs with jax and the
    JAX package absent: train_vae for an S-VAE and a D-VAE variant, then
    run_bo (GP only) on the S-VAE's latents and summarize on its result
    directory. jax is kept out by an import hook that raises, so that no
    "jax" entry sits in sys.modules (scipy's array-API helpers, which
    run_bo's statistics reach, look one up there)."""
    small = ["--max-count", "20", "--hs", "8", "--nz", "4", "--batch-size", "9",
             "--epochs", "1", "--save-interval", "1", "--cpu", "--no-test"]
    code = ("import sys, torch, importlib.abc\n"
            "torch.set_num_threads(1)\n"
            "class Absent(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'flax',"
            " 'dagnn_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Absent())\n"
            "from dagnn_tpu_torch.cli import run_bo, summarize, train_vae\n"
            f"train_vae.main({small!r} + ['--res_dir', 's', '--model', 'SVAE_GraphRNN_BFS'])\n"
            f"train_vae.main({small!r} + ['--res_dir', 'g', '--model', 'DVAE_DeepGMG'])\n"
            "run_bo.main(['--latent', 's/final_structures6_latent_epoch1.mat',"
            " '--seeds', '1', '--M', '8', '--gp-iters', '3', '--res_dir', 'bo',"
            " '--cpu'])\n"
            "summarize.main(['--res_dir', 'bo'])\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok") and "1 seeds" in out.stdout
    assert (tmp_path / "g" / "final_structures6_latent_epoch1.mat").exists()
    assert (tmp_path / "bo" / "Test_RMSE_ll.txt").exists()


def test_parallel_runs_without_jax(tmp_path):
    """The dry run's ranks (data parallel, both edge-partitioned schemes)
    with jax and the JAX package absent from the parent, whose modules the
    spawned ranks import again."""
    code = ("import sys, torch, importlib.abc\n"
            "torch.set_num_threads(1)\n"
            "class Absent(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'flax',"
            " 'dagnn_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Absent())\n"
            "from dagnn_tpu_torch.cli import dryrun\n"
            "if __name__ == '__main__':\n"
            "    dryrun.main(['--ranks', '2', '--cpu', '--timeout', '120'])\n"
            "    print('ok')\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok")
    assert "edge-partitioned pass ok" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_jax_package_imports(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "dagnn_tpu"), \
                f"{path} imports {n}"


def test_default_device_is_cuda():
    """Without a card, the default device raises instead of running on the
    CPU; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from dagnn_tpu_torch import flagship, resolve_device
    from dagnn_tpu_torch.convert import params_from_numpy
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    cfg = flagship.flagship_cfg(emb=4, hidden=4, vocab=5, seq=2, num_attrs=7)
    for call in (lambda: dagnn_init(0, cfg), lambda: resolve_device(),
                 lambda: params_from_numpy({"w": [[1.0]]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert dagnn_init(0, cfg, device="cpu")["head.w"].device.type == "cpu"
