"""The CUDA kernels against their plain versions on the card, at small odd
shapes the flagship run does not reach: the row kernels K1/K2 at one
direction (ndirs=1) and two, K2's split form after K5 (merge_tg=False),
the pair kernels K3/K4 on a synthetic pair step with ragged blocks and
intra-pair edges, the edge-softmax aggregate K6 (forward and backward,
with empty, fully masked and out-of-range slots, ids in random order,
negative ids, 613 edges on one slot, masked scores far above 88, Ke 0,
S 1, width 13, unaligned operands and one level of 32,768 edges), the
transpose-grad accumulate K5 (and K5 as the sum kinds' segment sum at
widths 13 and 305; the max kind's segment max on the card against the
CPU), the near/far modes K7 (ragged merged rows mixing "r", "t"
and "p", an empty near list, near edges that all read pad slots), K2
without residual streams (K2r, bitwise K2), K2's GEMM launches alone
(tensor cores in bf16), K1's two launches alone (the GRU on the tensor
cores in bf16; the attention with empty and single-slot lists, huge
masked scores and routed reads), the segment merge in each of its
forms, and the NA VAE's shapes (K6 and K5 in f32 at widths 501 and 509 on
a level of 32 live slots in 256, and one NA train step, kernels against
plain); the captured steps against the eager ones, the BO loop's programs
(the GP fit, greedy EI, the decode, the ENAS surrogate) included; with
and without edge
attributes, widths that are not multiples of the kernels' 32-wide tiles,
float32 and bfloat16.

These tests need a CUDA device and skip without one. On a machine with a
card (the JAX package absent), run them with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
Tolerances as in chip_smoke.py: max|kernel - plain| on each output's or
weight grad's own max|plain| (dagnn_tpu_torch.checks) at most 1e-4 in
float32 (sums in another order) and 3e-2 in bfloat16 (one bf16 rounding
step taken at a different point). Weight-grad elements that are zero in
exact arithmetic (told apart by the float32 plain backward on the same
inputs) hold rounding noise: the kernel's may be at most 8 times the plain
version's.
"""

import time

import numpy as np
import pytest
import torch

from dagnn_tpu_torch import checks

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
NOISE_TOL = 8.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(g, dt, dev, nd, has_ea, H, emb, nl, R):
    from dagnn_tpu_torch.ops import row_step as rs
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1) * 0.3
    qd = [emb] + [H] * (nl - 1)
    dirs = []
    for _ in range(nd):
        aggr = [{"attn_lin": {"w": u(1, qd[l] + H), "b": u(1)},
                 "edge_encoder": {"w": u(H, R), "b": u(H)}} for l in range(nl)]
        cells = [{"w_ih": u(3 * H, qd[l]), "w_hh": u(3 * H, H),
                  "b_ih": u(3 * H), "b_hh": u(3 * H)} for l in range(nl)]
        cast = lambda t: {k: cast(v) if isinstance(v, dict) else v.to(dt)
                          for k, v in t.items()}
        dirs.append(rs.flatten_row_weights([cast(a) for a in aggr],
                                           [cast(c) for c in cells], qd, has_ea))
    w = rs.stack_row_weights(dirs) if nd > 1 else dirs[0]
    return {k: v.to(dev) for k, v in w.items()}


def _operands(g, dt, dev, has_ea, d):
    """Move a dict of CPU operands to the card, the float ones in dt."""
    d = {k: (v.to(dt) if k in ("xin", "vals", "ea", "g", "tg") else v).to(dev)
         for k, v in d.items()}
    if not has_ea:
        d["ea"] = None
    return d


def _row(dt, dev, nd, has_ea, kn=40, ke=70, kt=50, H=45, emb=37, nl=2, R=3):
    g = torch.Generator().manual_seed(nd * 10 + has_ea)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1) * 0.3
    w = _weights(g, dt, dev, nd, has_ea, H, emb, nl, R)
    edst = torch.cat([torch.sort(torch.randint(0, kn, (ke,), generator=g))[0]
                      for _ in range(nd)])
    emask = torch.rand(nd * ke, generator=g) > 0.2
    edst[~emask] = kn
    tdst = torch.randint(0, kn + 1, (nd * kt,), generator=g)
    ea = torch.zeros(nd * ke, R)
    ea[torch.arange(nd * ke), torch.randint(0, R, (nd * ke,), generator=g)] = 1
    d = dict(xin=torch.randn(nd * kn, emb, generator=g),
             vals=u(nd * ke, nl * H) * 3, ea=ea, edst=edst.int(),
             emask=emask.float(),
             nmask=(torch.rand(nd * kn, generator=g) > 0.1).float(),
             g=torch.randn(nd * kn, nl * H, generator=g),
             tg=torch.randn(nd * kt, nl * H, generator=g), tdst=tdst.int(),
             tmask=(torch.rand(nd * kt, generator=g) > 0.3).float())
    return (has_ea, H, nl), _operands(g, dt, dev, has_ea, d), w


def _pair(dt, dev, has_ea, kn=40, H=45, emb=37, nl=2, R=3):
    """A synthetic pair step [A0|A1|B0|B1] with ragged odd widths: A blocks
    all gathered, B blocks a far region then intra-pair edges whose source
    slot nsrc lies in the same direction's A block (pad entries: edst and
    nsrc = Kn, mask 0)."""
    g = torch.Generator().manual_seed(100 + has_ea)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1) * 0.3
    w = _weights(g, dt, dev, 2, has_ea, H, emb, nl, R)
    blocks = (("p", 0, 70, 70, 33), ("p", 1, 53, 53, 21),
              ("q", 0, 61, 25, 29), ("q", 1, 47, 9, 17))
    edst, emask, nsrc = [], [], []
    for mode, _d, ke, kv, _kt in blocks:
        e = torch.sort(torch.randint(0, kn, (ke,), generator=g))[0]
        m = torch.rand(ke, generator=g) > 0.2
        e[~m] = kn
        ns = torch.full((ke,), kn)
        if mode == "q":
            ns[kv:] = torch.randint(0, kn, (ke - kv,), generator=g)
            ns[kv:][~m[kv:]] = kn
        edst.append(e)
        emask.append(m)
        nsrc.append(ns)
    W, U, T = (sum(b[2] for b in blocks), sum(b[3] for b in blocks),
               sum(b[4] for b in blocks))
    tdst = torch.randint(0, kn + 1, (T,), generator=g)
    ea = torch.zeros(W, R)
    ea[torch.arange(W), torch.randint(0, R, (W,), generator=g)] = 1
    d = dict(xin=torch.randn(4 * kn, emb, generator=g), vals=u(U, nl * H) * 3,
             ea=ea, edst=torch.cat(edst).int(), emask=torch.cat(emask).float(),
             nsrc=torch.cat(nsrc).int(),
             nmask=(torch.rand(4 * kn, generator=g) > 0.1).float(),
             g=torch.randn(4 * kn, nl * H, generator=g),
             tg=torch.randn(T, nl * H, generator=g), tdst=tdst.int(),
             tmask=(torch.rand(T, generator=g) > 0.3).float())
    return (has_ea, H, nl), _operands(g, dt, dev, has_ea, d), w, blocks


def _err(a, b):
    return checks.rel_err(a, b)[0]


def _check_backward(kb, pb, truth, again, dt, has_ea):
    """K2/K4 outputs against the plain version's; weight grads on their
    own scale with the exact-zero elements (truth) held to a noise bound;
    a second launch bitwise the first (no atomics in the sums)."""
    for a, b in zip(kb[:2], pb[:2]):
        assert _err(a, b) <= TOL[dt]
    assert (kb[2] is None) == (not has_ea)
    if has_ea:
        assert _err(kb[2], pb[2]) <= TOL[dt]
    tmax = checks.tree_max(truth)
    for name in pb[3]:
        rel, _, _, noise = checks.grad_err(kb[3][name], pb[3][name],
                                           truth[name], tmax)
        assert rel <= TOL[dt] and noise <= NOISE_TOL, (name, rel, noise)
    for name in kb[3]:
        assert torch.equal(again[3][name], kb[3][name]), name
    assert torch.equal(again[1], kb[1])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("has_ea", [True, False], ids=["ea", "noea"])
@pytest.mark.parametrize("nd", [1, 2])
def test_kernels_match_plain(dev, nd, has_ea, dt):
    from dagnn_tpu_torch.ops import row_step as rs
    st, d, w = _row(dt, dev, nd, has_ea)
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    for emit in (False, True):
        k = rs.row_forward(*fa, emit_res=emit, ndirs=nd)
        p = rs.row_forward_plain(*fa, emit_res=emit, ndirs=nd)
        for a, b in zip(k if emit else (k,), p if emit else (p,)):
            assert _err(a, b) <= TOL[dt]
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], (p[1], p[2]))
    kb = rs.row_backward(*ba, ndirs=nd)
    pb = rs.row_backward_plain(*ba, ndirs=nd)
    torch.cuda.synchronize()
    # the float32 plain backward on the same inputs marks the weight-grad
    # elements that are zero in exact arithmetic
    f = checks.to_f32(fa)
    f32res = rs.row_forward_plain(*f, emit_res=True, ndirs=nd)[1:]
    truth = rs.row_backward_plain(*f, *checks.to_f32(ba[8:12]), f32res, ndirs=nd)[3]
    _check_backward(kb, pb, truth, rs.row_backward(*ba, ndirs=nd), dt, has_ea)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("has_ea", [True, False], ids=["ea", "noea"])
def test_pair_kernels_match_plain(dev, has_ea, dt):
    from dagnn_tpu_torch.ops import pair_step as ps
    st, d, w, blocks = _pair(dt, dev, has_ea)
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"],
          d["nsrc"], w)
    for emit in (False, True):
        k = ps.pair_forward(*fa, blocks, emit_res=emit)
        p = ps.pair_forward_plain(*fa, blocks, emit_res=emit)
        for a, b in zip(k if emit else (k,), p if emit else (p,)):
            assert _err(a, b) <= TOL[dt]
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], (p[1], p[2]), blocks)
    kb = ps.pair_backward(*ba)
    pb = ps.pair_backward_plain(*ba)
    torch.cuda.synchronize()
    f = checks.to_f32(fa)
    f32res = ps.pair_forward_plain(*f, blocks, emit_res=True)[1:]
    truth = ps.pair_backward_plain(*f, *checks.to_f32(ba[9:13]), f32res,
                                   blocks)[3]
    _check_backward(kb, pb, truth, ps.pair_backward(*ba), dt, has_ea)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_backward_matches_plain(dev, dt):
    """K5 + K2 with merge_tg=False at one direction against the plain split
    form."""
    from dagnn_tpu_torch.ops import row_step as rs
    st, d, w = _row(dt, dev, 1, True, kn=33, ke=61, kt=47)
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    p = rs.row_forward_plain(*fa, emit_res=True)
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], (p[1], p[2]))
    n0 = dict(rs.launch_counts)
    kb = rs.row_backward(*ba, merge_tg=False)
    assert rs.launch_counts["tg_accumulate"] == n0["tg_accumulate"] + 1
    assert rs.launch_counts["row_backward"] == n0["row_backward"] + 1
    pb = rs.row_backward_plain(*ba, merge_tg=False)
    torch.cuda.synchronize()
    f = checks.to_f32(fa)
    f32res = rs.row_forward_plain(*f, emit_res=True)[1:]
    truth = rs.row_backward_plain(*f, *checks.to_f32(ba[8:12]), f32res)[3]
    _check_backward(kb, pb, truth, rs.row_backward(*ba, merge_tg=False), dt, True)


# K6 cases: (Ke, S, H) and what each adds to random dst / mask
K6_CASES = {
    "sorted": (77, 13, 45),              # odd H, empty / fully masked slots
    "unsorted": (300, 40, 64),           # dst in random order
    "613 on one slot": (900, 20, 45),    # more than a round, more than a list
    "masked above 88": (200, 17, 300),   # masked scores of 100-1000
    "ids out of range": (150, 11, 46),   # negative and >= S ids, mask set
    "H 13": (90, 11, 13),                # an odd width below a warp's lanes
    "Ke 0": (0, 9, 45),
    "S 1": (60, 1, 45),
    "H 300, 2-byte base": (512, 257, 300),   # values, scores, dst unaligned
    "Ke 32768": (32768, 257, 300),       # 16 chunks; 3,000 edges on one slot
}


def _segments(dt, dev, case, seed=0):
    """K6 operands for a case of K6_CASES on the card, with the cotangent
    and the slot count: about 25% masked edges; "sorted" also has slot 3
    empty, slot 6's edges all masked and its last two edges out of range
    (slot S, mask set)."""
    ke, s, h = K6_CASES[case]
    g = torch.Generator().manual_seed(seed)
    dst = torch.randint(0, s, (ke,), generator=g)
    mask = torch.rand(ke, generator=g) > 0.25
    sc = torch.randn(ke, generator=g)
    if case == "sorted":
        dst = torch.sort(dst)[0]
        dst[dst == 3] = 4
        mask[dst == 6] = False
        dst[-2:] = s
        mask[-2:] = True
    elif case == "613 on one slot":
        dst[torch.randperm(ke, generator=g)[:613]] = 5
        mask[dst == 5] = True
    elif case == "Ke 32768":
        dst[torch.randperm(ke, generator=g)[:3000]] = 7
    elif case == "masked above 88":
        sc = torch.where(mask, sc, 100 + 900 * torch.rand(ke, generator=g))
    elif case == "ids out of range":
        bad = torch.rand(ke, generator=g) < 0.2
        dst[bad] = torch.randint(-3, 0, (ke,), generator=g)[bad]
        dst[bad & (torch.rand(ke, generator=g) < 0.5)] = s + 1
        mask[bad] = True
    v = torch.randn(ke, h, generator=g)
    gout = torch.randn(s, h, generator=g)
    if case == "H 300, 2-byte base":
        # contiguous views one element into larger flat buffers
        flat = torch.zeros(ke * h + 1, dtype=dt, device=dev)
        flat[1:] = v.flatten().to(dt).to(dev)
        sflat = torch.zeros(ke + 1, dtype=dt, device=dev)
        sflat[1:] = sc.to(dt).to(dev)
        dflat = torch.zeros(ke + 1, dtype=torch.int32, device=dev)
        dflat[1:] = dst.int().to(dev)
        return (sflat[1:], flat[1:].view(ke, h), dflat[1:], mask.float().to(dev),
                gout.to(dt).to(dev), s)
    return (sc.to(dt).to(dev), v.to(dt).to(dev), dst.int().to(dev),
            mask.float().to(dev), gout.to(dt).to(dev), s)


@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_segment_attn_kernels_match_plain(dev, dt, case):
    """K6 forward and backward against their plain versions; empty, fully
    masked and out-of-range edges give zeros and never NaN; a second launch
    is bitwise the first (no atomics)."""
    from dagnn_tpu_torch.ops import segment_attn as sa
    sc, v, dst, mask, g, S = _segments(dt, dev, case)
    k = sa.segment_attn_forward(sc, v, dst, mask, S)
    kb = sa.segment_attn_backward(sc, v, dst, mask, g, S)
    torch.cuda.synchronize()
    assert k.dtype == dt and kb[0].dtype == dt and kb[1].dtype == dt
    assert k.shape == (S, v.shape[1]) and kb[1].shape == v.shape
    assert _err(k, sa.segment_attn_forward_plain(sc, v, dst, mask, S)) <= TOL[dt]
    for a, b in zip(kb, sa.segment_attn_backward_plain(sc, v, dst, mask, g, S)):
        assert _err(a, b) <= TOL[dt]
    valid = (mask > 0) & (dst >= 0) & (dst < S)
    deg = torch.bincount(dst[valid].long(), minlength=S)
    assert not k[deg == 0].any()
    assert not kb[0][~valid].any() and not kb[1][~valid].any()
    assert torch.equal(sa.segment_attn_forward(sc, v, dst, mask, S), k)
    again = sa.segment_attn_backward(sc, v, dst, mask, g, S)
    assert torch.equal(again[0], kb[0]) and torch.equal(again[1], kb[1])
    # through the autograd Function: one launch each way, the wrappers' bits
    # on the same operands (a clone may be aligned where a view was not, and
    # 8-byte columns sum a dot product's columns in another order)
    n0 = dict(sa.launch_counts)
    scr, vr = sc.clone().requires_grad_(True), v.clone().requires_grad_(True)
    out = sa.pallas_edge_softmax_aggregate(scr, vr, dst, mask, S)
    grads = torch.autograd.grad(out, (scr, vr), g)
    assert sa.launch_counts == {"segment_attn_forward": n0["segment_attn_forward"] + 1,
                                "segment_attn_backward": n0["segment_attn_backward"] + 1}
    want = sa.segment_attn_backward(scr.detach(), vr.detach(), dst, mask, g, S)
    assert torch.equal(out, k)
    assert torch.equal(grads[0], want[0]) and torch.equal(grads[1], want[1])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tg_accumulate_kernel_matches_plain(dev, dt):
    """K5 at odd widths with masked and pad (slot Kn) transpose edges;
    bitwise repeatable."""
    from dagnn_tpu_torch.ops import row_step as rs
    gen = torch.Generator().manual_seed(3)
    kn, kt, c = 37, 53, 90
    g = torch.randn(kn, c, generator=gen).to(dt).to(dev)
    tg = torch.randn(kt, c, generator=gen).to(dt).to(dev)
    tdst = torch.randint(0, kn + 1, (kt,), generator=gen).int().to(dev)
    tmask = (torch.rand(kt, generator=gen) > 0.3).float().to(dev)
    k = rs.tg_accumulate(g, tg, tdst, tmask)
    torch.cuda.synchronize()
    assert k.dtype == dt
    assert _err(k, rs.tg_accumulate_plain(g, tg, tdst, tmask)) <= TOL[dt]
    assert torch.equal(rs.tg_accumulate(g, tg, tdst, tmask), k)
    # no transpose edges: g itself
    assert torch.equal(rs.tg_accumulate(g, tg[:0], tdst[:0], tmask[:0]), g)


@pytest.mark.parametrize("c", [13, 305])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_merged_segment_sum_kernel_matches_plain(dev, dt, c):
    """K5 as the sum kinds' segment sum (ops/segment.merged_segment_sum:
    a zero base, the pad slot a real segment, masked edges and ids out of
    range dropped) at odd widths (13; gated_sum's 300 + vid_dim 5): one
    launch, against its plain version, bitwise repeatable, and its
    backward the masked gather of the cotangent."""
    from dagnn_tpu_torch.ops import row_step as rs
    from dagnn_tpu_torch.ops import segment
    gen = torch.Generator().manual_seed(4)
    ke, s = 70, 9
    v = torch.randn(ke, c, generator=gen).to(dt).to(dev).requires_grad_(True)
    ids = torch.randint(-1, s + 1, (ke,), generator=gen).int().to(dev)
    mask = (torch.rand(ke, generator=gen) > 0.3).float().to(dev)
    n0 = rs.launch_counts["tg_accumulate"]
    k = segment.merged_segment_sum(v, ids, s, mask, rs.tg_accumulate)
    assert rs.launch_counts["tg_accumulate"] == n0 + 1
    assert k.dtype == dt and k.shape == (s, c)
    p = segment.merged_segment_sum(v, ids, s, mask, rs.tg_accumulate_plain)
    assert _err(k, p) <= TOL[dt]
    assert torch.equal(segment.merged_segment_sum(v, ids, s, mask,
                                                  rs.tg_accumulate), k)
    g = torch.randn(s, c, generator=gen).to(dt).to(dev)
    (dv,) = torch.autograd.grad(k, v, g)
    valid = (mask > 0) & (ids >= 0) & (ids < s)
    want = torch.where(valid[:, None], g[ids.long().clamp(0, s - 1)], 0)
    assert torch.equal(dv, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_segment_max_on_card_matches_cpu(dev, dt):
    """The `max` kind's segment max (scatter_reduce on the card, no kernel
    of the port) with a tie, a fully masked and an empty segment: bf16's
    finfo.min is not float32's; the card gives the CPU's values and
    gradients bit for bit."""
    from dagnn_tpu_torch.ops import segment
    gen = torch.Generator().manual_seed(5)
    v = torch.randn(40, 13, generator=gen).to(dt)
    v[1] = v[0]
    ids = torch.randint(0, 6, (40,), generator=gen)
    ids[:2] = 2
    ids[ids == 4] = 3
    mask = torch.rand(40, generator=gen) > 0.25
    mask[:2] = True
    mask[ids == 5] = False
    g = torch.randn(6, 13, generator=gen).to(dt)
    outs = []
    for d in ("cpu", dev):
        vv = v.to(d).requires_grad_(True)
        out = segment.segment_max(vv, ids.to(d), 6, mask.to(d))
        outs.append((out.cpu(), torch.autograd.grad(out, vv, g.to(d))[0].cpu()))
    assert not outs[0][0][4:].any()          # slot 4 empty, slot 5 all masked
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


NF_ROWS = {
    "r+t": (("r", 70, 41), ("t", 53, 53)),
    "p+r, empty near list": (("p", 61, 61), ("r", 47, 47)),
    "r, near edges read pad slots": (("r", 66, 30),),
    "t": (("t", 59, 59),),
}


def _nf_row(dt, dev, nf, pad_near, kn=37, kt=43, H=45, emb=37, nl=2, R=3):
    """A near/far row of odd widths: per block sorted slots, ~20% pad
    edges (edst and nsrc = Kn, mask 0); under "r" the near edges after the
    Kf far ones, under "t" a third of the edges near; with pad_near every
    near edge (mask set) reads slot Kn, a pad. prev_out and near_g random."""
    g = torch.Generator().manual_seed(len(nf) * 7 + pad_near)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1) * 0.3
    nd = len(nf)
    w = _weights(g, dt, dev, nd, True, H, emb, nl, R)
    edst, emask, nsrc = [], [], []
    for mode, ke, kf in nf:
        cuts = [(0, kf), (kf, ke)] if mode == "r" else [(0, ke)]
        e = torch.cat([torch.sort(torch.randint(0, kn, (b - a,), generator=g))[0]
                       for a, b in cuts])
        m = torch.rand(ke, generator=g) > 0.2
        e[~m] = kn
        near = torch.zeros(ke, dtype=torch.bool)
        if mode == "r":
            near[kf:] = True
        elif mode == "t":
            near = torch.rand(ke, generator=g) < 0.35
        near &= m
        ns = torch.full((ke,), kn)
        if not pad_near:
            ns[near] = torch.randint(0, kn, (int(near.sum()),), generator=g)
        edst.append(e)
        emask.append(m)
        nsrc.append(ns)
    W = sum(b[1] for b in nf)
    U = sum(kf if m == "r" else ke for m, ke, kf in nf)
    ea = torch.zeros(W, R)
    ea[torch.arange(W), torch.randint(0, R, (W,), generator=g)] = 1
    d = dict(xin=torch.randn(nd * kn, emb, generator=g), vals=u(U, nl * H) * 3,
             ea=ea, edst=torch.cat(edst).int(), emask=torch.cat(emask).float(),
             nsrc=torch.cat(nsrc).int(),
             nmask=(torch.rand(nd * kn, generator=g) > 0.1).float(),
             prev_out=u(nd * kn, nl * H) * 3,
             near_g=torch.randn(nd * kn, nl * H, generator=g),
             g=torch.randn(nd * kn, nl * H, generator=g),
             tg=torch.randn(nd * kt, nl * H, generator=g),
             tdst=torch.randint(0, kn + 1, (nd * kt,), generator=g).int(),
             tmask=(torch.rand(nd * kt, generator=g) > 0.3).float())
    d = {k: (v.to(dt) if k in ("xin", "vals", "ea", "g", "tg", "prev_out",
                                 "near_g") else v).to(dev) for k, v in d.items()}
    return (True, H, nl), d, w


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(NF_ROWS))
def test_nf_kernels_match_plain(dev, case, dt):
    """K7 forward and backward (near_g in, near_g_out out) against the
    plain versions; "p" blocks and near edges that read pad slots give zero
    near_g_out rows; a second backward is bitwise the first."""
    from dagnn_tpu_torch.ops import row_step as rs
    nf = NF_ROWS[case]
    nd = len(nf)
    st, d, w = _nf_row(dt, dev, nf, "pad" in case)
    kw = dict(ndirs=nd, nf=nf, nsrc=d["nsrc"], prev_out=d["prev_out"])
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    n0 = dict(rs.launch_counts)
    for emit in (False, True):
        k = rs.row_forward(*fa, emit_res=emit, **kw)
        p = rs.row_forward_plain(*fa, emit_res=emit, **kw)
        for a, b in zip(k if emit else (k,), p if emit else (p,)):
            assert _err(a, b) <= TOL[dt]
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], (p[1], p[2]))
    kb = rs.row_backward(*ba, near_g=d["near_g"], **kw)
    pb = rs.row_backward_plain(*ba, near_g=d["near_g"], **kw)
    torch.cuda.synchronize()
    assert rs.launch_counts["row_forward_nf"] == n0["row_forward_nf"] + 2
    assert rs.launch_counts["row_backward_nf"] == n0["row_backward_nf"] + 1
    assert rs.launch_counts["row_forward"] == n0["row_forward"]
    f = checks.to_f32(fa)
    fkw = dict(kw, prev_out=d["prev_out"].float())
    f32res = rs.row_forward_plain(*f, emit_res=True, **fkw)[1:]
    truth = rs.row_backward_plain(*f, *checks.to_f32(ba[8:12]), f32res,
                                  near_g=d["near_g"].float(), **fkw)[3]
    again = rs.row_backward(*ba, near_g=d["near_g"], **kw)
    _check_backward(kb, pb, truth, again, dt, True)
    assert kb[4].dtype == dt and _err(kb[4], pb[4]) <= TOL[dt]
    assert torch.equal(again[4], kb[4])
    kn = d["xin"].shape[0] // nd
    for b, (mode, ke, kf) in enumerate(nf):
        if mode == "p" or "pad" in case or (mode == "r" and ke == kf):
            assert not kb[4][b * kn:(b + 1) * kn].any(), (case, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["plain", "r+t"])
def test_recompute_backward_is_bitwise(dev, case, dt):
    """K2r (res=None) recomputes the residual streams with K1's kernels
    from full-width values and is bitwise K2 fed by K1 on the same inputs;
    under nf its dvals are the far rows, its near_g_out the same."""
    from dagnn_tpu_torch.ops import row_step as rs
    if case == "plain":
        st, d, w = _row(dt, dev, 2, True, kn=35, ke=57, kt=41)
        kw, full = dict(ndirs=2), d["vals"]
    else:
        nf = NF_ROWS[case]
        st, d, w = _nf_row(dt, dev, nf, False)
        kn = d["xin"].shape[0] // len(nf)
        kw = dict(ndirs=len(nf), nf=nf, nsrc=d["nsrc"], near_g=d["near_g"])
        full = torch.cat([
            rs._block_vals(mode == "r", d["vals"], vo, kv, d["nsrc"][eo:eo + ke],
                           d["prev_out"][b * kn:(b + 1) * kn], kn)
            for b, (mode, eo, ke, vo, kv) in
            enumerate(rs.nf_blocks(nf, len(nf), d["edst"].shape[0]))])
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    pkw = {k: v for k, v in kw.items() if k != "near_g"}
    res = rs.row_forward(*fa, emit_res=True, prev_out=d.get("prev_out"),
                         **pkw)[1:]
    bw = (d["g"], d["tg"], d["tdst"], d["tmask"])
    k2 = rs.row_backward(*fa, *bw, res, prev_out=d.get("prev_out"), **kw)
    n0 = dict(rs.launch_counts)
    k2r = rs.row_backward(fa[0], fa[1], full, *fa[3:], *bw, None, **kw)
    torch.cuda.synchronize()
    assert rs.launch_counts["row_backward_recompute"] == n0["row_backward_recompute"] + 1
    assert rs.launch_counts["row_forward"] == n0["row_forward"]
    assert len(k2r) == len(k2)
    for i, (a, b) in enumerate(zip(k2r, k2)):
        if i == 3:
            assert all(torch.equal(a[n], b[n]) for n in b)
        else:
            assert torch.equal(a, b), i


def _launch(name, *args):
    """One C entry of the wavefront library on the current stream."""
    from dagnn_tpu_torch.ops import row_step as rs
    rs._check(getattr(rs._lib(), name)(
        *args, torch.cuda.current_stream().cuda_stream), name)


def _p(t):
    from dagnn_tpu_torch.ops.row_step import _ptr
    return _ptr(t)


# GEMM shapes that are not multiples of the 32-wide tiles: H and emb
# multiples of 4 take the cp.async route in bf16, odd ones the
# register-staged one
GEMM_SHAPES = {"odd": dict(kn=37, H=45, emb=37), "aligned": dict(kn=40, H=44, emb=36)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_gemms_match_plain(dev, shape, nd, dt):
    """K2's GEMM launches alone against float32 products of the same
    operands: gemm_nn with both of a layer's GEMMs in one launch (dagg =
    round(dgh w_hh + gz), dcur = dgi w_ih), wgrad adding dgi^T cur and
    dgh^T agg into f32 accumulators, rebuild's h_n = round(agg w_hn^T +
    b_hn) and its output rebuild (bitwise the plain combine); bitwise
    repeatable."""
    from dagnn_tpu_torch.ops import row_step as rs
    kn, H, emb = (GEMM_SHAPES[shape][k] for k in ("kn", "H", "emb"))
    gen = torch.Generator().manual_seed(nd * 7 + len(shape))
    r = lambda *s: torch.randn(s, generator=gen).to(dt).to(dev)
    f32 = lambda *s: torch.randn(s, generator=gen).to(dev)
    code, rows, J, ldg = rs._DT_CODE[dt], nd * kn, 3 * H, 4 * H
    dgh, dgi, whh, wih = r(rows, J), r(rows, J), r(nd, J, H), r(nd, J, emb)
    gz = f32(rows, H)
    cur, aggbuf = r(rows, emb), r(rows, ldg)
    F = lambda t: t.float()

    def gemm_nn():
        dagg, dcur = torch.empty(rows, H, dtype=dt, device=dev), f32(rows, emb)
        _launch("wf_gemm_nn", code, 0, nd, kn, H, emb, _p(dgh), _p(whh), _p(dagg),
                _p(gz), _p(dgi), _p(wih), _p(dcur))
        return dagg, dcur

    dagg, dcur = gemm_nn()
    blk = lambda t, d: t[d * kn:(d + 1) * kn]
    dagg_ref = torch.cat([(F(blk(dgh, d)) @ F(whh[d]) + blk(gz, d)).to(dt) for d in range(nd)])
    dcur_ref = torch.cat([F(blk(dgi, d)) @ F(wih[d]) for d in range(nd)])
    assert _err(dagg, dagg_ref) <= TOL[dt] and _err(dcur, dcur_ref) <= TOL[dt]
    again = gemm_nn()
    assert torch.equal(again[0], dagg) and torch.equal(again[1], dcur)

    dw0 = (f32(nd, J, emb), f32(nd, J, H))
    dw = [t.clone() for t in dw0]
    _launch("wf_wgrad", code, 0, nd, kn, H, emb, _p(dgi), _p(dgh), _p(cur), emb,
            _p(aggbuf), ldg, _p(dw[0]), _p(dw[1]))
    agg = aggbuf[:, :H]
    for d in range(nd):
        assert _err(dw[0][d] - dw0[0][d], F(blk(dgi, d)).T @ F(blk(cur, d))) <= TOL[dt]
        assert _err(dw[1][d] - dw0[1][d], F(blk(dgh, d)).T @ F(blk(agg, d))) <= TOL[dt]

    whh3, bhh = r(nd, J, H), r(nd, J)
    nres = aggbuf                       # agg, z, n at columns 0, H, 2H (ld 4H)
    nmask = (torch.rand(rows, generator=gen) > 0.2).float().to(dev)
    tab, n = rs._tab(rs.row_table(None, nd, 0, 0))
    hn = torch.empty(rows, H, dtype=dt, device=dev)
    out = torch.empty(rows, H, dtype=dt, device=dev)
    _launch("wf_rebuild", code, tab, n, kn, H, _p(nres), _p(nres[:, H:]), _p(nres[:, 2 * H:]),
            ldg, _p(whh3), _p(bhh), _p(nmask), _p(hn), _p(out), H)
    hn_ref = torch.cat([(F(blk(agg, d)) @ F(whh3[d, 2 * H:]).T + F(bhh[d, 2 * H:])).to(dt)
                        for d in range(nd)])
    assert _err(hn, hn_ref) <= TOL[dt]
    z, nn_ = F(nres[:, H:2 * H]), F(nres[:, 2 * H:3 * H])
    assert torch.equal(out, (((1.0 - z) * nn_ + z * F(agg)) * nmask[:, None]).to(dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_gru_fwd_matches_f32_products(dev, shape, nd, dt):
    """K1/K3's GRU launch alone (tensor cores in bf16) against float32
    products of the same operands: r, z and n from cur w_ih^T + agg w_hh^T
    and the biases; the output bitwise the combine of the launch's own
    stored z and n (K2's rebuild recombines them); bitwise repeatable.
    agg and the residuals lie in an nres-like buffer (leading dimension 4H)."""
    from dagnn_tpu_torch.ops import row_step as rs
    kn, H, emb = (GEMM_SHAPES[shape][k] for k in ("kn", "H", "emb"))
    gen = torch.Generator().manual_seed(nd * 11 + len(shape))
    r = lambda *s: (0.5 * torch.randn(s, generator=gen)).to(dt).to(dev)
    code, rows, ldr = rs._DT_CODE[dt], nd * kn, 4 * H
    cur, nres = r(rows, emb), r(rows, ldr)
    wih, whh = r(nd, 3 * H, emb), r(nd, 3 * H, H)
    brz, bin_, bhn = r(nd, 2 * H), r(nd, H), r(nd, H)
    nmask = (torch.rand(rows, generator=gen) > 0.2).float().to(dev)
    F = lambda t: t.float()

    def run():
        res = nres.clone()
        out = torch.empty(rows, H, dtype=dt, device=dev)
        _launch("wf_gru_fwd", code, 0, nd, kn, H, emb, _p(cur), emb, _p(res), ldr,
                _p(wih), _p(whh), _p(brz), _p(bin_), _p(bhn), _p(nmask), _p(out), H,
                _p(res[:, H:]), _p(res[:, 2 * H:]), _p(res[:, 3 * H:]), ldr)
        return out, res

    out, res = run()
    agg = F(nres[:, :H])
    for d in range(nd):
        b = slice(d * kn, (d + 1) * kn)
        gi = F(cur[b]) @ F(wih[d]).T
        gh = agg[b] @ F(whh[d]).T
        rr = torch.sigmoid(gi[:, :H] + gh[:, :H] + F(brz[d, :H]))
        zz = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H] + F(brz[d, H:]))
        nn_ = torch.tanh(gi[:, 2 * H:] + F(bin_[d]) + rr * (gh[:, 2 * H:] + F(bhn[d])))
        for name, got, want in (("r", res[b, H:2 * H], rr), ("z", res[b, 2 * H:3 * H], zz),
                                ("n", res[b, 3 * H:], nn_)):
            assert _err(got, want.to(dt)) <= TOL[dt], (name, d)
    assert torch.equal(res[:, :H], nres[:, :H])          # agg is read, not written
    z, n = F(res[:, 2 * H:3 * H]), F(res[:, 3 * H:])
    assert torch.equal(out, (((1.0 - z) * n + z * agg) * nmask[:, None]).to(dt))
    again = run()
    assert torch.equal(again[0], out) and torch.equal(again[1], res)


# attn_fwd alone: (kn, ke, the law of the edges, nf). "random": sorted
# slots, masked edges and pad slots (Kn), ke not a multiple of 4 or 32;
# "one slot": 613 edges all on slot 5 (slots 0-4 and 6.. empty) but pads;
# "huge masked": masked edges on real slots whose scores exceed 88;
# "routed": a K7 "r" block, the tail of its edges read from prev_out
# through nsrc, pad nsrc (Kn) among them
ATTN_CASES = {"random": (37, 70, "random", None), "one slot": (29, 613, "one", None),
              "huge masked": (23, 45, "huge", None),
              "routed": (37, 97, "random", (("r", 97, 41),))}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [45, 44])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_fwd_matches_plain(dev, case, H, dt):
    """K1/K3's attention launch alone against row_forward_plain's first
    layer (its alpha32 and agg) on one block: an empty slot gets agg 0,
    masked edges with huge scores stay out (no NaN), pad slots and pad
    nsrc read nothing, alpha32 is 0 on every invalid edge; H 44 takes the
    4-column loads, 45 one column a lane; bitwise repeatable."""
    from dagnn_tpu_torch.ops import row_step as rs
    kn, ke, law, nf = ATTN_CASES[case]
    emb, R = 37, 3
    g = torch.Generator().manual_seed(ke + H)
    w = _weights(g, dt, dev, 1, True, H, emb, 1, R)
    if law == "one":
        edst = torch.full((ke,), 5)
    else:
        edst = torch.sort(torch.randint(0, kn, (ke,), generator=g))[0]
    emask = torch.rand(ke, generator=g) > 0.2
    pad = torch.rand(ke, generator=g) < 0.1
    edst[pad] = kn
    if law == "random":
        edst[edst == 0] = 1                      # slot 0 has no edges
    ea = torch.zeros(ke, R)
    ea[torch.arange(ke), torch.randint(0, R, (ke,), generator=g)] = 1
    kv = nf[0][2] if nf else ke
    vals = (torch.rand(kv, H, generator=g) * 2 - 1) * 0.5
    if law == "huge":                            # masked: k . wk far above 88
        vals[~emask] = 400 * torch.sign(w["a0_wk"].float().cpu()).flatten()
    d = dict(xin=torch.randn(kn, emb, generator=g), vals=vals, ea=ea, edst=edst.int(),
             emask=emask.float(), nmask=torch.ones(kn))
    if nf:
        nsrc = torch.full((ke,), kn)
        nsrc[kv:] = torch.randint(0, kn + 1, (ke - kv,), generator=g)
        d.update(nsrc=nsrc.int(), prev_out=torch.randn(kn, H, generator=g))
    d = {k: (v.to(dt) if k in ("xin", "vals", "ea", "prev_out") else v).to(dev)
         for k, v in d.items()}
    st = (True, H, 1)
    _, pa32, pres = rs.row_forward_plain(
        st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w,
        emit_res=True, nf=nf, nsrc=d.get("nsrc"), prev_out=d.get("prev_out"))
    tab, nb = rs._tab(rs.row_table(nf, 1, ke, 0))
    src = d.get("prev_out")

    def run():
        a32 = torch.full((ke, 1), float("nan"), device=dev)
        agg = torch.full((kn, 4 * H), float("nan"), dtype=dt, device=dev)
        _launch("wf_attn_fwd", rs._DT_CODE[dt], tab, nb, kn, H, emb, R, _p(d["xin"]), emb,
                _p(d["vals"]), H, _p(d.get("nsrc")), _p(src), H, _p(d["ea"]), _p(d["edst"]),
                _p(d["emask"]), _p(w["a0_wq"]), _p(w["a0_wk"]), _p(w["a0_b"]), _p(w["a0_we"]),
                _p(w["a0_be"]), _p(a32), 1, _p(agg), 4 * H)
        return a32, agg[:, :H]

    a32, agg = run()
    valid = (d["emask"] > 0) & (d["edst"] < kn)
    assert torch.isfinite(a32).all() and torch.isfinite(agg.float()).all()
    assert not a32[~valid].any()
    assert _err(a32, pa32) <= TOL[dt] and _err(agg, pres[:, :H]) <= TOL[dt]
    empty = torch.ones(kn, dtype=torch.bool, device=dev)
    empty[d["edst"][valid].long()] = False
    assert empty.any() and not agg[empty].any()
    if law == "huge":
        assert (~d["emask"].bool()).any()
    again = run()
    assert torch.equal(again[0], a32) and torch.equal(again[1], agg)


def _merge_ref(base, src, idx, mask, so, to, kt, kn, gadd):
    """base + (the f32 sum of src rows so.. over entries to.. of idx whose
    mask is set and slot lies in [0, kn)) + gadd, computed in float64."""
    i, m = idx[to:to + kt].long(), mask[to:to + kt] > 0
    ok = m & (i >= 0) & (i < kn)
    s = torch.zeros(kn + 1, src.shape[1], dtype=torch.float64, device=src.device)
    s.index_add_(0, torch.where(ok, i, kn), src[so:so + kt].double())
    s = s[:kn]
    if gadd is not None:
        s = s + gadd.double()
    return s if base is None else base.double() + s


# (kt, the slots' law): a list longer than a warp and than the block's
# staged chunk of 2048 entries, all on one slot; an empty list; random
# slots with pad entries (slot Kn) and masked ones
MERGE_LISTS = {"one slot, 2100 entries": (2100, "one"), "empty": (0, "rand"),
               "random with pads": (300, "rand")}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lh", [90, 96])
@pytest.mark.parametrize("case", list(MERGE_LISTS))
@pytest.mark.parametrize("form", ["tg_accumulate", "gtot base", "src_at_vo", "gadd"])
def test_seg_merge_forms(dev, form, case, lh, dt):
    """seg_merge in each form it serves, against a float64 sum: K5
    (tg_accumulate: g + the sum, rounded), the f32 gtot as its own base
    (K4's intra-pair merge), a zero base with src rows at the table's vo
    stored rounded (K7's near-grad merge), and g + the sum + gadd into gtot
    (K2's transpose merge with the next row's near grads); two blocks of
    different offsets; L*H 96 takes 16-byte columns, 90 one a lane;
    bitwise repeatable."""
    from dagnn_tpu_torch.ops import row_step as rs
    kt, law = MERGE_LISTS[case]
    kn, nb = 29, 2
    gen = torch.Generator().manual_seed(kt + lh)
    r = lambda *s: torch.randn(s, generator=gen).to(dt).to(dev)
    idx = (torch.full((nb * kt,), 5) if law == "one"
           else torch.randint(0, kn + 1, (nb * kt,), generator=gen)).int().to(dev)
    mask = (torch.rand(nb * kt, generator=gen) > 0.25).float().to(dev)
    if form == "tg_accumulate":
        g, tg = r(kn, lh), r(kt, lh)
        k = rs.tg_accumulate(g, tg, idx[:kt], mask[:kt])
        ref = _merge_ref(g.float(), tg, idx, mask, 0, 0, kt, kn, None)
        assert k.dtype == dt and _err(k, ref.to(dt)) <= TOL[dt]
        assert torch.equal(rs.tg_accumulate(g, tg, idx[:kt], mask[:kt]), k)
        return
    code = rs._DT_CODE[dt]
    vo = 7                               # src rows of block b at vo + b*kt (src_at_vo)
    src = r(vo + nb * kt + 3, lh)
    g, gadd = r(nb * kn, lh), r(nb * kn, lh)
    gtot0 = torch.randn(nb * kn, lh, generator=gen).to(dev)
    tab = tuple((b, b, 0, 0, vo + b * kt, 0, b * kt, kt, -1) for b in range(nb))
    t, n = rs._tab(tab)

    def run():
        gtot, gout = gtot0.clone(), torch.empty(nb * kn, lh, dtype=dt, device=dev)
        if form == "gtot base":
            _launch("wf_seg_merge", code, t, n, kn, lh, 0, 0, _p(src), _p(idx), _p(mask),
                    0, _p(gtot), 0)
            return gtot
        if form == "src_at_vo":
            _launch("wf_seg_merge", code, t, n, kn, lh, 1, 0, _p(src), _p(idx), _p(mask),
                    0, 0, _p(gout))
            return gout
        _launch("wf_seg_merge", code, t, n, kn, lh, 0, _p(g), _p(src), _p(idx), _p(mask),
                _p(gadd), _p(gtot), 0)
        return gtot

    k = run()
    blk = lambda x, b: None if x is None else x[b * kn:(b + 1) * kn]
    for b in range(nb):
        so = vo + b * kt if form == "src_at_vo" else b * kt
        base = {"gtot base": gtot0, "src_at_vo": None, "gadd": g}[form]
        ref = _merge_ref(blk(base, b), src, idx, mask, so, b * kt, kt, kn,
                         blk(gadd, b) if form == "gadd" else None)
        kb = blk(k, b)
        assert _err(kb, ref.to(kb.dtype)) <= TOL[kb.dtype], b
    assert torch.equal(run(), k)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nd", [1, 2])
def test_backward_is_bitwise_repeatable(dev, nd, dt):
    """K2 twice on the same inputs gives the same bits in every output and
    weight grad: no atomics, every sum in a fixed order."""
    from dagnn_tpu_torch.ops import row_step as rs
    st, d, w = _row(dt, dev, nd, True, kn=44, ke=90, kt=70, H=44, emb=36)
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    res = rs.row_forward(*fa, emit_res=True, ndirs=nd)[1:]
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], res)
    a, b = rs.row_backward(*ba, ndirs=nd), rs.row_backward(*ba, ndirs=nd)
    for i in (0, 1, 2):
        assert torch.equal(a[i], b[i]), i
    assert all(torch.equal(a[3][k], b[3][k]) for k in a[3])


# ------------------------------------------------ the NA VAE's shapes (f32)

def _na_batch(n_graphs=32):
    """The NA VAE's first train batch of the repo's ENAS corpus at the
    scripts' widths (na_train.sh: hs 501, nz 56, batch 32), collated as
    its driver collates it: every level Kn 256 slots, Ke 1,024 edges, of
    which one node a graph and its in-edges are live."""
    import os
    from dagnn_tpu_torch.cli import train_vae
    args = train_vae.parse_args(["--max-count", "200"])
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "final_structures6.txt.gz")
    from dagnn_tpu_torch.data.na import load_enas
    train, _, ga = load_enas(path, max_count=200)
    return args, train[:n_graphs], ga


@pytest.mark.parametrize("H", [501, 509])
def test_vae_level_kernels_match_plain(dev, H):
    """K6 forward and backward and K5 (the transpose merge, and the sum
    kinds' segment sum) in f32 at widths 501 and 509, whose 2,004- and
    2,036-byte rows take K6's one-column path, on the busiest level of the
    NA batch: Kn 256 slots of which 32 live, Ke 1,024 edges mostly
    masked, the transpose schedule Kt 1,024 mostly masked."""
    from dagnn_tpu_torch.ops import row_step as rs
    from dagnn_tpu_torch.ops import segment
    from dagnn_tpu_torch.ops import segment_attn as sa
    from dagnn_tpu_torch.vae.dagnn_vae import DAGNNVAEConfig, na_collate
    _, graphs, ga = _na_batch()
    cfg = DAGNNVAEConfig(max_n=ga.max_n, nvt=ga.num_vertex_type)
    b = na_collate(graphs, cfg)[0].fwd
    row = int(b.edge_mask.sum(1).argmax())
    kn, ke = b.node_ids.shape[1], b.edge_dst.shape[1]
    assert (kn, ke) == (256, 1024) and int(b.node_mask[row].sum()) == 32
    dst = torch.as_tensor(b.edge_dst[row]).int().to(dev)
    mask = torch.as_tensor(b.edge_mask[row]).float().to(dev)
    assert 0 < int(mask.sum()) < ke // 4
    g = torch.Generator().manual_seed(11)
    sc = torch.randn(ke, generator=g).to(dev)
    v = torch.randn(ke, H, generator=g).to(dev)
    gout = torch.randn(kn + 1, H, generator=g).to(dev)
    S = kn + 1
    k = sa.segment_attn_forward(sc, v, dst, mask, S)
    kb = sa.segment_attn_backward(sc, v, dst, mask, gout, S)
    torch.cuda.synchronize()
    assert _err(k, sa.segment_attn_forward_plain(sc, v, dst, mask, S)) <= TOL[torch.float32]
    for a, p in zip(kb, sa.segment_attn_backward_plain(sc, v, dst, mask, gout, S)):
        assert _err(a, p) <= TOL[torch.float32]
    assert torch.equal(sa.segment_attn_forward(sc, v, dst, mask, S), k)
    tdst = torch.as_tensor(b.tgrad_dst[row]).int().to(dev)
    tmask = torch.as_tensor(b.tgrad_mask[row]).float().to(dev)
    kt = tdst.shape[0]
    assert kt == 1024 and int(tmask.sum()) < kt // 4
    gg = torch.randn(kn, H, generator=g).to(dev)
    tg = torch.randn(kt, H, generator=g).to(dev)
    m = rs.tg_accumulate(gg, tg, tdst, tmask)
    assert _err(m, rs.tg_accumulate_plain(gg, tg, tdst, tmask)) <= TOL[torch.float32]
    assert torch.equal(rs.tg_accumulate(gg, tg, tdst, tmask), m)
    s = segment.merged_segment_sum(v, dst, S, mask, rs.tg_accumulate)
    assert _err(s, segment.merged_segment_sum(v, dst, S, mask,
                                              rs.tg_accumulate_plain)) <= TOL[torch.float32]


@pytest.mark.parametrize("agg", ["attn_h", "gated_sum"])
def test_na_train_step_kernels_match_plain(dev, agg):
    """One f32 NA train step at the scripts' widths (hs 501, nz 56, 2
    layers, batch 32) with the encoder on the kernels (K6 and K5) and on
    their plain versions, from one set of weights: loss and gradient norm
    within 1e-5 relative, every leaf within rtol 5e-4 / atol 5e-5; K6
    launched 2 x 16 forward and 16 backward (attn_h), K5 16 (the transpose
    merges) or 48 (gated_sum: also the sums, forward and replayed)."""
    from dagnn_tpu_torch.cli import train_vae
    from dagnn_tpu_torch.nn.aggregators import SEG_KERNELS, SEG_PLAIN
    from dagnn_tpu_torch.ops import row_step as rs
    from dagnn_tpu_torch.ops import segment_attn as sa
    args, graphs, ga = _na_batch()
    args.dagnn_agg = agg
    model = train_vae.VAEModel(args, ga, dev)
    params = model.init(0)
    prepared = model.prepare(graphs)

    def step(impl):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total = model.loss(p, prepared, None, training=False, impl=impl)[0]
        gs = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        gs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}
        norm = torch.sqrt(sum((g * g).sum() for g in gs.values()))
        return float(total.detach()), gs, float(norm)

    rs.reset_launch_counts()
    sa.reset_launch_counts()
    kl, kg, kn = step(SEG_KERNELS)
    n = 2 * 8
    if agg == "attn_h":
        assert sa.launch_counts == {"segment_attn_forward": 2 * n,
                                    "segment_attn_backward": n}
        assert rs.launch_counts["tg_accumulate"] == n
    else:
        assert rs.launch_counts["tg_accumulate"] == 3 * n
    pl, pg, pn = step(SEG_PLAIN)
    assert abs(kl - pl) <= 1e-5 * abs(pl) and abs(kn - pn) <= 1e-5 * pn
    for k in pg:
        torch.testing.assert_close(kg[k], pg[k], rtol=5e-4, atol=5e-5, msg=k)


# ----------------------------- captured steps (train/graphs.py) on the card

def _bucket(dev, task="tok", dropout=0.0):
    """A small odd config (emb / hidden 45, bf16) and three host batches of
    one loader bucket (their output slots widened to the loader's): the
    flagship's merged route (TOK) or main_lp's generic branch (LP:
    gated_sum, one direction, K5)."""
    import dataclasses
    from dagnn_tpu_torch import convert, flagship
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    graphs = synthetic_ast_batch(5, 30, mean_nodes=17, vocab=23, seq_len=3,
                                 num_attrs=40)
    cfg = flagship.flagship_cfg(emb=45, hidden=45, vocab=23, seq=3, num_attrs=40)
    if task == "lp":
        for g in graphs:
            g.y["len_longest_path"] = np.asarray(min(g.len_longest_path, 6), np.int32)
        cfg = dataclasses.replace(cfg, agg="gated_sum", bidirectional=False,
                                  num_vocab=0, num_class=7)
    cfg = dataclasses.replace(cfg, dropout=dropout)
    loader = DAGLoader(graphs, 10, shuffle=True, seed=2, chunk_size=16, prefetch=0)
    hosts = [convert.widen_out_slots(b, loader.out_per_graph) for b in loader]
    return cfg, dagnn_init(0, cfg, device=dev), hosts


def _five_steps(cfg, params, hosts, task, capture, gen=None, seed=0):
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train.optim import make_optimizer
    opt = make_optimizer(1e-3, 0.25)
    train_step, predict = make_step_fns(cfg, opt, task, capture=capture)
    p, s = params, opt.init(params)
    if gen is not None:
        gen.manual_seed(seed)
    losses = []
    for i in (0, 1, 2, 0, 1):
        p, s, loss, _ = train_step(p, s, hosts[i], gen)
        losses.append(float(loss))
    return (losses, {k: v.clone() for k, v in p.items()},
            predict(p, hosts[0]), train_step)


@pytest.mark.parametrize("task", ["tok", "lp"])
def test_captured_steps_equal_eager_steps(dev, task):
    """Five steps over three batches of one bucket (0, 1, 2, 0, 1), the
    driver's captured train step against its eager one: the eager steps
    repeat bit for bit on these paths (no atomics), so the replays must
    equal them bit for bit, losses, parameters and predicted ids; one
    capture, five replays."""
    cfg, params, hosts = _bucket(dev, task)
    assert len(hosts) == 3
    e1, e2 = (_five_steps(cfg, params, hosts, task, False) for _ in range(2))
    assert e1[0] == e2[0] and all(torch.equal(e1[1][k], e2[1][k]) for k in e1[1])
    g = _five_steps(cfg, params, hosts, task, True)
    assert g[0] == e1[0]
    for k in e1[1]:
        assert torch.equal(g[1][k], e1[1][k]), k
    assert torch.equal(g[2], e1[2])
    cap = g[3].captured
    assert (cap.captures, cap.replays) == (1, 5)
    assert all(v.graph is not None for v in cap.graphs.values())


def test_dropout_masks_under_a_reseeded_generator(dev):
    """Dropout draws from the driver's generator: the replays after
    manual_seed(s) draw what the eager steps draw after manual_seed(s),
    and a second reseed to s draws the same masks again."""
    cfg, params, hosts = _bucket(dev, dropout=0.3)
    gen = torch.Generator(device=dev)
    eager = _five_steps(cfg, params, hosts, "tok", False, gen, seed=11)
    graph = _five_steps(cfg, params, hosts, "tok", True, gen, seed=11)
    again = _five_steps(cfg, params, hosts, "tok", True, gen, seed=11)
    other = _five_steps(cfg, params, hosts, "tok", True, gen, seed=12)
    assert graph[0] == eager[0] == again[0]
    assert other[0] != graph[0]
    for k in eager[1]:
        assert torch.equal(graph[1][k], eager[1][k]), k


def test_replays_count_their_capture_launches(dev):
    """read_launch_counts: each replay adds the launches its capture
    issued; the set-up (warm-up and capture) adds nothing; the wrappers'
    own counts do not move on a replay."""
    from dagnn_tpu_torch import ops
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train.optim import make_optimizer
    cfg, params, hosts = _bucket(dev)
    opt = make_optimizer(1e-3, 0.25)
    eager, _ = make_step_fns(cfg, opt, "tok", capture=False)
    graph, _ = make_step_fns(cfg, opt, "tok")
    ops.reset_launch_counts()
    eager(params, opt.init(params), hosts[0])
    one = {k: v for k, v in ops.read_launch_counts().items() if v}
    assert set(one) == {"row_forward", "row_backward"}
    ops.reset_launch_counts()
    p, s, _, _ = graph(params, opt.init(params), hosts[0])
    own = ops.wrapper_counts()
    for _ in range(2):
        p, s, _, _ = graph(p, s, hosts[1])
    assert ops.wrapper_counts() == own == {k: 0 for k in own}
    counts = ops.read_launch_counts()
    assert counts == {k: 3 * one.get(k, 0) for k in counts}


def test_graph_nodes_hold_what_a_replay_launches(dev):
    """graphs.graph_nodes reads a captured LP step's nodes from the graph
    itself (debug mode): its K5 kernel (seg_merge_kernel) once for each
    tg_accumulate launch of the eager step, and a copy node for each state
    leaf written back in place."""
    from dagnn_tpu_torch import convert, ops
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train import graphs
    from dagnn_tpu_torch.train.optim import make_optimizer
    cfg, params, hosts = _bucket(dev, "lp")
    opt = make_optimizer(1e-3, 0.25)
    eager, _ = make_step_fns(cfg, opt, "lp", capture=False)
    graph, _ = make_step_fns(cfg, opt, "lp")
    graph.captured.debug = True
    ops.reset_launch_counts()
    eager(params, opt.init(params), hosts[0])
    one = {k: v for k, v in ops.read_launch_counts().items() if v}
    assert set(one) == {"tg_accumulate"}
    p, s, _, _ = graph(params, opt.init(params), hosts[0])
    nodes = graphs.graph_nodes(graph.captured.last_graph())
    by_name = {}
    for k, v in nodes.items():
        by_name[graphs.kernel_name(k)] = by_name.get(graphs.kernel_name(k), 0) + v
    assert by_name.get("seg_merge_kernel") == one["tg_accumulate"]
    n_state = len(convert.flatten_tree(p)) + len(convert.flatten_tree(s))
    assert nodes.get("memcpy", 0) >= n_state


def test_captured_vae_step_equals_eager_step(dev):
    """The NA VAE's captured train step (hs 45, nz 6, attn_h; K6 and K5)
    over three batches of 8 graphs, the learning rate changed every call,
    against the eager step from the same weights and noise seed: bit for
    bit, parameters and loss sums."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import train_vae
    from dagnn_tpu_torch.train.optim import make_optimizer
    args, graphs, ga = _na_batch(24)
    args.hs, args.nz = 45, 6
    model = train_vae.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = make_optimizer(1e-3, 0.25)
    step = train_vae.make_train_step(model, opt)
    captured = train_vae.make_captured_step(step)
    hosts = [model.prepare_host(graphs[i:i + 8]) for i in (0, 8, 16)]
    gc, ge = (torch.Generator(device=dev).manual_seed(3) for _ in range(2))
    st = (params, opt.init(params), torch.zeros(3, device=dev))
    pe, se, sums = params, opt.init(params), torch.zeros(3, device=dev)
    for host, lr in zip(hosts, (1e-3, 1e-4, 2e-3)):
        inputs = (host, np.asarray(lr, np.float32), gc)
        st, _ = captured(("vae", convert.batch_key(inputs)), st, inputs, (gc,))
        pe, se, stats = step(pe, se, convert.batch_to_torch(host, dev), ge, lr)
        sums = sums + stats
        assert all(torch.equal(st[0][k], pe[k]) for k in pe), lr
        assert torch.equal(st[2], sums)
    assert (captured.captures, captured.replays) == (1, 3)


def test_captured_vae_epochs_replay_the_tail(dev):
    """Two NA VAE epochs (hs 45, nz 6; 43 graphs in batches of 8 and
    chunks of 2: five full batches and a tail of 3) through train_epoch,
    captured against eager from the same weights, permutations and noise
    seeds: bit for bit, parameters, Adam's state and each epoch's loss
    sums; one capture a key (the full batches' and the tail's), one replay
    a batch."""
    from dagnn_tpu_torch.cli import train_vae
    from dagnn_tpu_torch.train.optim import make_optimizer
    args, graphs, ga = _na_batch(43)
    args.hs, args.nz, args.batch_size, args.scan_chunk = 45, 6, 8, 2
    model = train_vae.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = make_optimizer(1e-3, 0.25)
    step = train_vae.make_train_step(model, opt)
    captured = train_vae.make_captured_step(step)
    runs = {}
    for tag, cap in (("captured", captured), ("eager", None)):
        rnd, gen = np.random.default_rng(1), torch.Generator(device=dev)
        state, sums = (params, opt.init(params)), []
        for epoch in (1, 2):
            gen.manual_seed(100 + epoch)
            p, s, total = train_vae.train_epoch(
                args, model, step, *state, graphs, rnd.permutation(len(graphs)),
                gen, 1e-3, epoch, time.time(), cap)
            state = (p, s)
            sums.append(total.clone())
        runs[tag] = ({k: v.clone() for k, v in state[0].items()},
                     {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                      else v.clone() for k, v in state[1].items()}, sums)
    (pc, sc, uc), (pe, se, ue) = runs["captured"], runs["eager"]
    assert all(torch.equal(pc[k], pe[k]) for k in pe)
    assert all(torch.equal(sc[k][n], se[k][n]) for k in ("mu", "nu") for n in se[k])
    assert all(torch.equal(a, b) for a, b in zip(uc, ue))
    assert (captured.captures, captured.replays) == (2, 12)


# ------------------------ captured steps of the other models on the card

def _baseline_bucket(dev, gnn="gin-virtual", dropout=0.3):
    """A baseline's config at a small odd width (emb 45, dropout on) and
    three host batches of one unleveled loader bucket (odd graph sizes)."""
    import argparse
    from dagnn_tpu_torch.cli import ogb_driver
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    graphs = synthetic_ast_batch(7, 27, mean_nodes=19, vocab=23, seq_len=3,
                                 num_attrs=40)
    args = ogb_driver.add_common_args(argparse.ArgumentParser()).parse_args(
        ["--gnn", gnn, "--emb_dim", "45", "--num_vocab", "21", "--max_seq_len",
         "3", "--dagnn_dropout", str(dropout)])
    cfg = ogb_driver.build_model_cfg(args, "tok", num_nodeattributes=40)
    loader = DAGLoader(graphs, 9, shuffle=True, seed=2, chunk_size=0,
                       prefetch=0, schedules=False)
    return cfg, ogb_driver.init_params(cfg, 0, dev), list(loader)


def test_captured_mpnn_step_equals_eager_step(dev):
    """gin-virtual (emb 45, dropout 0.3) over three batches of one bucket:
    the driver's captured train step against its eager one from the same
    weights and generator seed, bit for bit (losses, parameters, Adam
    state, predicted ids); the graph's K5 nodes (seg_merge_kernel) those
    of the eager step's launches; one capture, three replays."""
    from dagnn_tpu_torch import convert, ops
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train import graphs
    from dagnn_tpu_torch.train.optim import make_optimizer
    cfg, params, hosts = _baseline_bucket(dev)
    assert len(hosts) == 3
    opt = make_optimizer(1e-3, 0.25)
    runs = {}
    for capture in (True, False):
        train_step, predict = make_step_fns(cfg, opt, "tok", capture=capture)
        if capture:
            train_step.captured.debug = True
        p, s = params, opt.init(params)
        gen = torch.Generator(device=dev).manual_seed(4)
        seen = []
        ops.reset_launch_counts()
        for h in hosts:
            p, s, loss, _ = train_step(p, s, h, gen)
            seen.append((float(loss), {k: v.clone() for k, v in p.items()},
                         convert.flatten_tree(convert.tree_map(torch.clone, s))))
        runs[capture] = (seen, ops.read_launch_counts(), predict(p, hosts[0]),
                         train_step)
    (g, gc, gi, gs), (e, ec, ei, _) = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(g, e)):
        assert a[0] == b[0], i
        for k in b[1]:
            assert torch.equal(a[1][k], b[1][k]), (i, k)
        for k in b[2]:
            assert torch.equal(a[2][k], b[2][k]), (i, k)
    assert torch.equal(gi, ei)
    assert gc == ec and ec["tg_accumulate"] > 0
    cap = gs.captured
    assert (cap.captures, cap.replays) == (1, 3)
    nodes = graphs.graph_nodes(cap.last_graph())
    seg = sum(v for k, v in nodes.items()
              if graphs.kernel_name(k) == "seg_merge_kernel")
    assert 3 * seg == ec["tg_accumulate"]


def test_captured_svae_step_equals_eager_step(dev):
    """SVAE_GraphRNN (hs 45, nz 7; the graph-level and edge-level GRUs)
    over three batches of 8 ENAS graphs, the learning rate changed every
    call: the captured train step against the eager one from the same
    weights and noise seed, bit for bit (parameters, loss sums); no kernel
    of the port in the graph."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import train_vae
    from dagnn_tpu_torch.train import graphs
    from dagnn_tpu_torch.train.optim import make_optimizer
    args, gs, ga = _na_batch(24)
    args.model, args.hs, args.nz = "SVAE_GraphRNN", 45, 7
    model = train_vae.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = make_optimizer(1e-3, 0.25)
    step = train_vae.make_train_step(model, opt)
    captured = train_vae.make_captured_step(step)
    captured.debug = True
    hosts = [model.prepare_host(gs[i:i + 8]) for i in (0, 8, 16)]
    gc, ge = (torch.Generator(device=dev).manual_seed(3) for _ in range(2))
    st = (params, opt.init(params), torch.zeros(3, device=dev))
    pe, se, sums = params, opt.init(params), torch.zeros(3, device=dev)
    for host, lr in zip(hosts, (1e-3, 1e-4, 2e-3)):
        inputs = (host, np.asarray(lr, np.float32), gc)
        st, _ = captured(("vae", convert.batch_key(inputs)), st, inputs, (gc,))
        pe, se, stats = step(pe, se, convert.batch_to_torch(host, dev), ge,
                             torch.tensor(lr, device=dev))
        sums = sums + stats
        assert all(torch.equal(st[0][k], pe[k]) for k in pe), lr
        assert torch.equal(st[2], sums)
    assert (captured.captures, captured.replays) == (1, 3)
    names = {graphs.kernel_name(k) for k in graphs.graph_nodes(captured.last_graph())}
    assert not names & {"seg_merge_kernel", "sa_fwd_kernel", "sa_bwd_kernel"}


@pytest.mark.parametrize("kind,dropout", [("dp", 0.0), ("dp", 0.25), ("ep", 0.0)],
                         ids=["dp", "dp_dropout", "ep"])
def test_captured_parallel_steps_equal_eager_steps(dev, kind, dropout, tmp_path):
    """A world-size-1 NCCL group in this process (jobs.forms_job): the DP
    step (merged, K1/K2; also with dropout, step i drawing from seed i
    through the generator registered with the graph) and the EP step
    (D = 1, scan rows 64; K6, K5, in both orders) captured, one CUDA graph
    per key, against the eager steps over three Adam steps from the same
    weights: the loss, every parameter and optimizer leaf (digests) and
    the collectives bit for bit (each replay counts its capture's); the
    same arrays with other read_rows a new key."""
    import dataclasses
    import torch.distributed as dist
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.parallel.dp import collate_sharded
    from dagnn_tpu_torch.parallel.mesh import release_graphs
    cfg = dataclasses.replace(flagship.flagship_cfg(emb=32, hidden=32), dropout=dropout)
    graphs = synthetic_ast_batch(0, 12, mean_nodes=20)
    if kind == "dp":
        batch = collate_sharded(graphs, 1, flagship.pad_for(graphs))
    else:
        batch = collate(graphs, dataclasses.replace(flagship.pad_for(graphs, chunk=64),
                                                    nodes_per_level=64))
    pnp = {k: v.numpy() for k, v in dagnn_init(0, cfg, device="cpu").items()}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        r = jobs.forms_job(dev, kind, cfg, pnp, batch, mesh_shape=(1, 1), steps=3)
    finally:
        release_graphs()
        dist.destroy_process_group()
    f = r["forms"]
    pairs = [("captured", "eager")] + ([("captured sync", "eager sync"),
                                        ("captured", "captured sync")] if kind == "ep" else [])
    for a, b in pairs:
        for k in ("losses", "params", "state", "issued"):
            assert f[a][k] == f[b][k], (a, b, k)
    assert f["captured"]["issued"]["device"] > 0 and f["captured"]["issued"]["host"] == 0
    assert r["form"] == "captured" and r["route"] == "device"
    assert (r["captures"], r["replays"]) == ((2, 4) if kind == "ep" else (1, 3))


# --------------------------------------- the BO loop's captured programs

def _gp_data(n=160, d=5, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    return X, np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + 0.1 * rng.standard_normal(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bo_fit_and_ei_captured_equal_eager(dev, dtype):
    """The GP fit through sparse_gp.FIT (one Adam step a graph, replayed 8
    times), on masked padding rows, and a round of 3 greedy-EI candidates
    through sparse_gp.EI, on the card in float32 and float64: bit for bit
    their eager forms; a second fit of the key replays without a
    capture."""
    from dagnn_tpu_torch.vae import sparse_gp as T
    X, y = _gp_data()
    Xd, yd = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (X, y))
    kw = dict(M=24, iters=8, lr=1e-2, pad_to=190)
    fits, c = {}, None
    for seed in (0, 1):
        c = T.FIT.captures if seed else c
        for capture in (False, True):
            fits[seed, capture] = T.fit_sparse_gp(Xd, yd, seed=seed, capture=capture, **kw)
    for seed in (0, 1):
        a, b = fits[seed, True], fits[seed, False]
        assert a.refit_f64 == b.refit_f64
        assert all(torch.equal(a.params[k], b.params[k]) for k in a.params), seed
    assert T.FIT.captures == c
    gp = fits[0, True]
    args = (3, X.min(0), X.max(0), X.mean(0), X.std(0))
    ei = dict(grid_size=500, refine_iters=10, seed=1)
    cand = [T.batched_greedy_ei(gp, *args, capture=c, **ei) for c in (False, True)]
    assert cand[1].dtype == gp.X.dtype and torch.equal(cand[0], cand[1])


@pytest.mark.parametrize("dec_agg", ["gated_sum", "attn"])
def test_bo_decode_captured_equals_eager(dev, dec_agg):
    """dvae.DECODE's graph (the generator registered) against the eager
    decode from a generator of the same seed on the card: the same types,
    adjacency and vertex counts, stochastic and greedy; two replays of one
    key draw on from where the generator stands, as the eager decodes do."""
    from dagnn_tpu_torch.vae import dvae as td
    cfg = td.DVAEConfig(max_n=8, nvt=8, hs=45, nz=6, vid=True, dec_agg=dec_agg)
    g = torch.Generator().manual_seed(3)
    dec = td.dvae_decoder_init(g, cfg, device=dev)
    attn = None
    if dec_agg == "attn":
        attn = {"attn_lin.w": (torch.rand(1, cfg.nvt + cfg.vs, generator=g) - 0.5).to(dev),
                "attn_lin.b": torch.zeros(1, device=dev)}
    z = 2.0 * torch.randn(37, 6, generator=g).to(dev)
    for stochastic in (True, False):
        gens = [torch.Generator(device=dev).manual_seed(7) for _ in range(2)]
        for _ in range(2):
            a, b = (td.dvae_decode(dec, cfg, z, gen, stochastic, attn, capture=c)
                    for gen, c in zip(gens, (True, False)))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_bo_surrogate_captured_equals_eager(dev, tmp_path):
    """enas_eval.FIT's step replayed 40 epochs on the corpus's first 300
    rows leaves the parameters the eager epochs leave, bit for bit, and
    PREDICT's graph predicts what the eager MLP does."""
    import gzip
    import os
    from dagnn_tpu_torch.vae import enas_eval as tev
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "data", "final_structures6.txt.gz")
    path = tmp_path / "enas300.txt"
    with gzip.open(src, "rt") as f, open(path, "w") as out:
        for _, line in zip(range(300), f):
            out.write(line)
    got, want = (tev.EvalENAS(str(path), epochs=40, device=dev, capture=c)
                 for c in (True, False))
    assert all(torch.equal(got._params[k], want._params[k]) for k in got._params)
    X = np.stack([tev.featurize_row(r) for r in list(got.table)[:33]])
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    assert tev.FIT.captures >= 1 and tev.PREDICT.captures >= 2
