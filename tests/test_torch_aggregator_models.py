"""The aggregator kinds inside the model, the port against the JAX package
from the same weights (the JAX init carried over by convert.py):
  * the model grid of tests/test_dagnn.py:50-73, its 11 configs with
    another aggregator than attn_h (attn_x, mattn_h, self_attn_h/x,
    gated_sum with and without the mapper's bias, add, max, and the three
    agg_x configs; test_torch_config_surface.py holds the attn_h ones), on
    the generic branch as there;
  * vid_dim under gated_sum and attn_h;
  * ref_shared_agg_quirk on bidirectional add and max both ways;
  * self_attn_h and mattn_h on segment_impl="pallas" (the JAX side's
    Pallas kernel in interpret mode).
Tolerances as ROADMAP sets them: f32 outputs 2e-5, f32 grads rtol 5e-4 /
atol 5e-5 (test_torch_config_surface.matches_jax).
"""

import pytest
import torch

from dagnn_tpu.dag.batch import collate as jcollate
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.nn import dagnn as tdagnn
from test_dagnn import CONFIGS
from test_torch_config_surface import (configs, grid_case, grid_graphs,
                                       grid_ids, matches_jax, to_port)

torch.set_num_threads(1)


KINDS = [i for i, o in enumerate(CONFIGS) if o["agg"] != "attn_h"]


@pytest.mark.parametrize("i", KINDS, ids=grid_ids(KINDS))
def test_grid_kinds_match_jax(i):
    grid_case(i)


@pytest.mark.parametrize("agg", ["gated_sum", "attn_h"])
def test_vid_dim_matches_jax(agg):
    """The D-VAE coupling (dagnn_tpu/vae/dagnn_vae.py:93-115): one-hot
    vertex ids (global node index mod vid_dim) beside gated_sum's values
    and attn_h's keys and later queries, the reverse aggregator separate
    (ref_shared_agg_quirk False)."""
    jcfg, tcfg = configs({"agg": agg}, vid_dim=5, ref_shared_agg_quirk=False,
                         segment_impl="scatter")
    graphs = grid_graphs(8, seed=3)
    matches_jax(jcfg, tcfg, jcollate(graphs), tcollate(to_port(graphs)))


@pytest.mark.parametrize("agg, quirk, pool_all", [
    ("add", False, True), ("max", False, True), ("max", True, False)])
def test_shared_aggregator_quirk_matches_jax(agg, quirk, pool_all):
    """add / max bidirectional: with ref_shared_agg_quirk the reverse
    pass aggregates nothing (its edges and transpose grads masked, also
    on the slot-space readout); without it the reverse aggregator runs.
    The grid holds add and max with the quirk on the node-space readout."""
    jcfg, tcfg = configs({"agg": agg}, ref_shared_agg_quirk=quirk,
                         out_pool_all=pool_all, segment_impl="scatter")
    assert tcfg.reverse_agg_noop == quirk
    graphs = grid_graphs(8, seed=12)
    _, tg = matches_jax(jcfg, tcfg, jcollate(graphs), tcollate(to_port(graphs)))
    rev = tg["aggr.1.0.edge_encoder.w"]
    assert (not rev.any()) == quirk


@pytest.mark.parametrize("agg", ["self_attn_h", "mattn_h"])
def test_pallas_kinds_match_jax(agg):
    """self_attn_h and mattn_h on segment_impl="pallas": the port's K6
    wrappers (their plain versions on the CPU) against the JAX package's
    Pallas kernel in interpret mode."""
    jcfg, tcfg = configs({"agg": agg}, segment_impl="pallas")
    graphs = grid_graphs(8, seed=13)
    tb = tcollate(to_port(graphs))
    assert tdagnn._route(tcfg, tb, None) == ("generic", tdagnn.SEG_KERNELS)
    matches_jax(jcfg, tcfg, jcollate(graphs), tb)
