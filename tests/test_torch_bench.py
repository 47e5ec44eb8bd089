"""The port's bench (dagnn_tpu_torch/bench.py) and its cost model
(dagnn_tpu_torch/roofline.py) against the JAX package's bench.py.

- The analytic roofline fields (model_tflops, hbm_gb_est, seq_rows,
  us_per_row) equal JAX `bench._roofline`'s on the bench's own 160 graphs
  at the flagship config, merged and with a pair plan of 2, at JAX's
  rounding; mfu is compared as model FLOPs (mfu x dt x the peak), since
  the two benches' peaks differ, at a dt where JAX's rounded mfu keeps 4
  significant digits. Pure arithmetic: nothing is compiled.
- The port's parameter count equals the JAX pytree's (35,254,914).
- The executed census is each launch's `row_ops`, the operations
  `kernel_costs` bounds that launch by.
- `main` on the CPU at small module constants prints the metric line and
  the roofline line with their keys, times at least one group when
  DAGNN_BENCH_STEPS exceeds 16, and raises without a card unless given
  --cpu; a card without peaks raises.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dagnn_tpu.dag.batch import collate as jcollate
from dagnn_tpu.nn.dagnn import dagnn_init as jinit
from dagnn_tpu_torch import bench, flagship, roofline
from dagnn_tpu_torch.dag.batch import collate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.nn.dagnn import dagnn_init

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_PARAMS = 35_254_914


def _jax_bench():
    """The JAX package's bench.py (the repo root's), loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(scope="module")
def graphs():
    return synthetic_ast_batch(0, bench.GRAPHS, mean_nodes=bench.MEAN_NODES)


@pytest.mark.parametrize("pair", [0, 2])
def test_roofline_matches_jax_bench(graphs, pair):
    jb = _jax_bench()
    jpad = ge._pad_for(graphs)
    if pair:   # bench.py:146-152
        jpad = dataclasses.replace(jpad, pair=pair,
                                   max_levels=jpad.max_levels + jpad.max_levels % 2)
    jbatch = jcollate(graphs, jpad)
    cfg = flagship.flagship_cfg()
    host = collate(graphs, flagship.pad_for(graphs, pair=pair))
    model = roofline.model_flops(cfg, host)
    # mfu near 0.5 at JAX's peak: its 4 decimals are 4 significant digits
    dt = model / jb.PEAK_BF16_FLOPS / 0.5
    want = jb._roofline(ge._flagship_cfg(), jbatch, dt, FLAGSHIP_PARAMS)
    got = roofline.roofline(cfg, host, dt, FLAGSHIP_PARAMS,
                            roofline.peaks(roofline.H100_SXM))
    assert round(got["model_tflops"], 3) == want["model_tflops"]
    assert round(got["hbm_gb_est"], 2) == want["hbm_gb_est"]
    assert got["seq_rows"] == want["seq_rows"]
    assert round(got["us_per_row"], 2) == want["us_per_row"]
    # model FLOPs behind each mfu, within half a unit of JAX's last digit
    jax_model = want["mfu"] * dt * jb.PEAK_BF16_FLOPS
    port_model = got["mfu"] * dt * roofline.peaks(roofline.H100_SXM)["bf16_flops"]
    assert abs(port_model - model) <= 1e-9 * model
    assert abs(jax_model - model) <= 0.5e-4 * dt * jb.PEAK_BF16_FLOPS
    L = host.fwd.node_ids.shape[0]
    assert got["seq_steps"] == (L // 2 if pair else L)
    assert got["us_per_step"] == pytest.approx(dt / got["seq_steps"] * 1e6)
    assert got["executed_tflops"] is None and got["device_busy_share"] is None


def test_param_count_matches_jax():
    cfg = flagship.flagship_cfg()
    n = sum(v.numel() for v in dagnn_init(0, cfg, device="cpu").values())
    jp = jinit(jax.random.PRNGKey(0), ge._flagship_cfg())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp)) == FLAGSHIP_PARAMS


@pytest.mark.parametrize("pair", [0, 2])
def test_executed_census_is_each_launch_ops(pair):
    """One launch a step: the census equals the sum of kernel_costs' ops
    over the plan's steps, each built from the step's own masks."""
    g = synthetic_ast_batch(3, 12, mean_nodes=20)
    cfg = flagship.flagship_cfg(emb=8, hidden=8)
    host = collate(g, flagship.pad_for(g, chunk=32, edge_budget=48, pair=pair))
    kn, H, nl, R = host.fwd.node_ids.shape[1], 8, 2, cfg.num_rels
    w = {k: torch.zeros(2) for k in ("0_wq", "0_we")}
    z = lambda *s: torch.zeros(s)
    if pair:
        steps = [(torch.as_tensor(e), torch.as_tensor(t)) for e, t in
                 zip(host.pair.emask, host.pair.tmask)]
        kn2, names = 4 * kn, ("pair_forward", "pair_backward")
    else:
        cat = lambda a, b, s: torch.as_tensor(np.concatenate([a[s], b[s]]))
        steps = [(cat(host.fwd.edge_mask, host.rev.edge_mask, s),
                  cat(host.fwd.tgrad_mask, host.rev.tgrad_mask, s))
                 for s in range(host.fwd.node_ids.shape[0])]
        kn2, names = 2 * kn, ("row_forward", "row_backward")
    want = 0
    for emask, tmask in steps:
        d = dict(xin=z(kn2, 8), vals=z(1, 1), ea=z(emask.shape[0], R),
                 edst=z(emask.shape[0]), emask=emask.float(), nmask=z(kn2),
                 g=z(1), tg=z(1), tdst=z(tmask.shape[0]), tmask=tmask.float())
        _, fo, _, bo = roofline.kernel_costs((True, H, nl), d, w, torch.bfloat16)
        want += fo + bo
    n = len(steps)
    got = roofline.executed_flops(cfg, host, {names[0]: n, names[1]: n})
    assert got == want + 3 * roofline.head_flops(cfg, host)
    half = roofline.executed_flops(cfg, host, {names[0]: n})
    assert half < got


def _small(monkeypatch):
    monkeypatch.setattr(bench, "GRAPHS", 6)
    monkeypatch.setattr(bench, "MEAN_NODES", 10)
    monkeypatch.setattr(bench, "WIDTH", 8)


def test_main_prints_the_metric_and_roofline_lines(monkeypatch, capsys):
    _small(monkeypatch)
    out = bench.main(["--cpu", "--roofline"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["metric"] for ln in lines] == ["edges_per_s_per_chip_fwdbwd", "roofline"]
    assert set(lines[0]) == {"metric", "value", "unit", "vs_baseline", "device",
                             "step"}
    assert lines[0]["unit"] == "edges/s" and lines[0]["device"] == "cpu"
    assert lines[0]["step"] == "graph"
    assert np.isfinite(lines[0]["value"]) and lines[0]["value"] > 0
    assert lines[0]["vs_baseline"] == pytest.approx(lines[0]["value"] / 1e6)
    keys = {"model_tflops", "executed_tflops", "mfu", "executed_vs_peak", "hbm_gb_est",
            "hbm_util_est", "seq_rows", "us_per_row", "seq_steps", "us_per_step",
            "device_busy_share"}
    assert keys <= set(lines[1])
    # no card: no device number is written under a device metric's name
    for k in ("mfu", "executed_vs_peak", "hbm_util_est", "device_busy_share",
              "executed_tflops"):
        assert lines[1][k] is None
    assert lines[1]["seq_steps"] * 2 == lines[1]["seq_rows"] // 2   # pair of 2
    # 8 timed groups of 2 steps after the warm-up group, then one profiled
    # group (a replay of the captured chain: 2 steps)
    assert out["passes"] == 2 * (8 + 1) + 2 and out["metric"] == lines[0]
    # the warm-up group captured the chain (staged on the CPU), every
    # group after it replayed it
    assert (out["captured"].captures, out["captured"].replays) == (1, 10)


def test_eager_bench_steps_launch_by_launch(monkeypatch, capsys):
    """--eager: each step issued from Python, launch by launch; no captured step."""
    _small(monkeypatch)
    out = bench.main(["--cpu", "--nopair", "--eager"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["step"] == "eager" and line["value"] > 0
    assert out["captured"] is None and out["passes"] == 2 * (8 + 1)


def test_more_than_16_steps_times_one_group(monkeypatch, capsys):
    _small(monkeypatch)
    monkeypatch.setenv("DAGNN_BENCH_STEPS", "17")
    out = bench.main(["--cpu", "--nopair"])
    assert (out["n_chain"], out["iters"], out["passes"]) == (17, 1, 34)
    assert out["metric"]["value"] > 0


def test_no_card_raises_and_unknown_card_has_no_peaks():
    with pytest.raises(ValueError, match="A100"):
        roofline.peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(SystemExit):
        bench.parse_args(["--pairs"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
