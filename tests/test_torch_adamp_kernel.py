"""The multi-leaf AdamP kernel (`ops/adamp_kernel.py`, `csrc/adamp.cu`) and
`AdamP.apply`.

On the CPU: the static leaf table against `gate_inputs`' arithmetic, the
work items' cover of every element, a torch emulation of the kernel's
three passes over the table against the plain path, the dispatch rule and
`apply`'s plain branch against `update` and the masked commit. On the card
(marker `card`, skipped elsewhere): the kernel against the plain path.
This file imports no JAX, so that the card tests run where JAX is absent:

    python -m pytest tests/test_torch_adamp_kernel.py -m card --noconftest
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from hilcodec_tpu_torch.ops import adamp_kernel as AK
from hilcodec_tpu_torch.train import optim as TO
from hilcodec_tpu_torch.utils import params as P

GATE_MARGIN = 1e-3
GROUPS = [{"regex_list": ["^chan/"], "project_channel": True,
           "weight_decay": 1e-2, "lr_scale": 0.5},
          {"regex_list": ["^big/"], "weight_decay": 0.0, "lr_scale": 2.0}]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda", 0)


def gate_tree(seed=0, scale=1):
    """numpy params / grads whose gate takes each branch: 'ortho' (grad
    orthogonal to each channel: the channel projection), 'layer'
    (orthogonal to the whole weight, not to each channel: the layer
    projection), 'free' (grad along the weight: none); a bias, a weight in
    the project_channel group, a 0-d gain, and, with `scale` > 1, leaves
    whose rows are cut into several slices or taken by groups of lanes
    and a 4-d one ('big/...', a group with its own lr_scale and no weight
    decay)."""
    rng = np.random.default_rng(seed)
    f32 = (lambda a: np.asarray(a, np.float32))

    def ortho(shape):
        p = rng.standard_normal(shape)
        g = rng.standard_normal(shape)
        axes = tuple(range(1, len(shape)))
        g -= (np.sum(g * p, axis=axes, keepdims=True)
              / np.sum(p * p, axis=axes, keepdims=True)) * p
        return f32(p), f32(g)

    def layer(rows, cols):
        p = np.ones((rows, cols))
        sign = np.where(np.arange(rows) % 2 == 0, 1.0, -1.0)[:, None]
        g = sign * np.ones((rows, cols)) + 0.001 * rng.standard_normal(
            (rows, cols))
        return f32(p), f32(g)

    def free(shape):
        p = rng.standard_normal(shape)
        return f32(p), f32(2.0 * p + 0.1 * rng.standard_normal(shape))

    leaves = {"ortho": ortho((4, 3, 5)), "layer": layer(2, 6),
              "free": free((3, 4)),
              "bias": (f32(rng.standard_normal(5)),
                       f32(rng.standard_normal(5))),
              "gain": (f32(rng.standard_normal(())),
                       f32(rng.standard_normal(()))),
              "chan": {"w": (f32(rng.standard_normal((6, 2))),
                             f32(rng.standard_normal((6, 2))))}}
    if scale > 1:
        leaves["big"] = {
            "ortho": ortho((3, 2 * scale * AK.CHUNK // 3 + 7)),
            "layer": layer(4, AK.LONG_ROW * scale + 1),
            "free": free((scale * 40, 33, 3)),
            "conv": free((scale * 8, 6, 5, 3)),
            "short": ortho((scale * 300, 1, 1)),
            "vec": (f32(rng.standard_normal(scale * 5000 + 3)),
                    f32(rng.standard_normal(scale * 5000 + 3)))}
    return _split(leaves, 0), _split(leaves, 1)


def _split(tree, i):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]


def to_t(tree, device="cpu", dtype=torch.float32):
    return P.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device,
                                                                 dtype),
                      tree)


def make(name="AdamP", nesterov=False, weight_decay=1e-3):
    kw = {"lr": 1e-3, "betas": [0.5, 0.9], "weight_decay": weight_decay,
          "nesterov": nesterov}
    return TO.make_optimizer(name, kw, GROUPS)[0]


def flat_list(tree):
    return list(P.flatten(tree).values())


# -- the static table --------------------------------------------------------

def test_leaf_table_matches_gate_inputs():
    opt = make()
    params, grads = gate_tree(scale=2)
    fp = P.flatten(to_t(params))
    fg = P.flatten(to_t(grads))
    shapes = [tuple(t.shape) for t in fp.values()]
    table = AK.build_table(shapes, [opt.resolved_options(k) for k in fp],
                           opt.delta)
    li, lf = table.leaves_i, table.leaves_f
    prev_end = 0
    for k, (path, p) in enumerate(fp.items()):
        numel, off, rows, length, pbase, nsl, rbase, mode = li[k].tolist()
        assert numel == p.numel()
        assert off % AK.ALIGN == 0 and off >= prev_end
        prev_end = off + numel
        assert rows == (p.shape[0] if p.ndim else 1)
        assert rows * length == numel
        opts = opt.leaf_options(path.replace(".", "/"))
        assert lf[k, AK.LR_SCALE] == np.float32(opts.get("lr_scale", 1.0))
        assert lf[k, AK.WEIGHT_DECAY] == np.float32(
            opts.get("weight_decay", opt.weight_decay))
        if opts.get("project_channel", False):
            assert mode == 1, path
        elif p.ndim <= 1:
            assert mode == 0, path
        else:
            assert mode == 2, path
            _, ch_t, _, ly_t = TO.gate_inputs(p, fg[path], opt.delta,
                                              opt.eps)
            assert lf[k, AK.THR_CH] == np.float32(ch_t), path
            assert lf[k, AK.THR_LY] == np.float32(ly_t), path
        assert nsl == (math.ceil(length / AK.CHUNK)
                       if length >= AK.LONG_ROW else 1)
    assert table.total == -(-prev_end // AK.ALIGN) * AK.ALIGN
    # the sizes the test means to reach: slices, lane groups, flat chunks
    assert li[:, AK.NSL].max() >= 2
    assert 0 in table.items_a[:, 1]
    assert len(set(table.items_a[:, 1].tolist()) - {0}) >= 3
    # Adam: the gate never opens, every leaf but the project_channel one
    # is mode 0
    adam = make("Adam")
    t_adam = AK.build_table(shapes, [adam.resolved_options(k) for k in fp],
                            adam.delta)
    chan = [k for k, path in enumerate(fp) if path.startswith("chan.")]
    assert set(np.flatnonzero(t_adam.leaves_i[:, AK.MODE])) == set(chan)


def test_work_items_cover_each_element_once():
    opt = make()
    params, _ = gate_tree(scale=3)
    fp = P.flatten(to_t(params))
    table = AK.build_table([tuple(t.shape) for t in fp.values()],
                           [opt.resolved_options(k) for k in fp], opt.delta)
    li = table.leaves_i
    hits_a = np.zeros(table.total, np.int64)
    hits_b = np.zeros(table.total, np.int64)
    parts = np.zeros(table.partials, np.int64)
    for leaf, kind, x, y, part in table.items_a.tolist():
        numel, off, rows, length, pbase, nsl, _, mode = li[leaf].tolist()
        if kind == 0:
            hits_a[off + x:off + x + y] += 1
            assert 0 < y <= AK.CHUNK
            if mode:
                # a slice of one row, whose partial is its (row, slice)
                row, s = divmod(x, length)
                assert (x + y - 1) // length == row
                assert part == pbase + row * nsl + s // AK.CHUNK
                parts[part] += 1
            else:
                assert part == -1
        else:
            assert mode and length < AK.LONG_ROW and nsl == 1
            assert kind == AK.lanes_per_row(length)
            assert AK.THREADS % kind == 0 and 32 % kind == 0
            hits_a[off + x * length:off + (x + y) * length] += 1
            assert part == pbase + x
            parts[part:part + y] += 1
    for leaf, x, y in table.items_b.tolist():
        assert li[leaf, AK.MODE] != 0
        off = li[leaf, AK.OFF]
        hits_b[off + x:off + x + y] += 1
    want_a = np.zeros(table.total, np.int64)
    want_b = np.zeros(table.total, np.int64)
    for numel, off, *_, mode in li.tolist():
        want_a[off:off + numel] = 1
        want_b[off:off + numel] = 1 if mode else 0
    np.testing.assert_array_equal(hits_a, want_a)
    np.testing.assert_array_equal(hits_b, want_b)
    np.testing.assert_array_equal(parts, np.ones(table.partials, np.int64))
    assert table.rlist.tolist() == np.flatnonzero(li[:, AK.MODE]).tolist()
    assert table.rowcoefs == int(li[table.rlist, AK.ROWS].sum())


def test_dynamic_table_reads_strided_leaves():
    """The per-call table: each leaf's pointers, and for a leaf with a
    tensor in another layout its shape and strides, through which the
    kernel reads element e (row-major) at sum_d index_d(e) stride_d; a
    leaf of more than 4 dims in another layout is refused."""
    g = torch.randn(4, 3, 5, 2)
    trees = [[torch.randn(7), torch.randn(4, 3, 5, 2), torch.randn(3, 6),
              torch.randn(2, 1, 2, 2, 3)] for _ in range(4)]
    trees[1][1] = g.contiguous(memory_format=torch.channels_last)
    trees[2][2] = torch.randn(6, 3).t()
    table = AK.dynamic_table(trees)
    n = 4
    head, layouts = table[:5 * n], table[5 * n:].reshape(-1, 20)
    assert head[4 * n:].tolist() == [-1, 0, 1, -1]
    for k in range(n):
        for col in range(4):
            t = trees[col][k]
            assert head[4 * k + col] == t.data_ptr()
            if head[4 * n + k] < 0:
                continue
            lay = layouts[head[4 * n + k]].tolist()
            flat = t.reshape(-1)
            store = torch.as_strided(t, (t.untyped_storage().nbytes() // 4
                                         - t.storage_offset(),), (1,))
            for e in range(t.numel()):
                off, r = 0, e
                for d in (3, 2, 1, 0):
                    off += (r % lay[d]) * lay[4 + 4 * col + d]
                    r //= lay[d]
                assert store[off] == flat[e], (k, col, e)
    trees[3][3] = torch.randn(3, 2, 2, 1, 2).permute(4, 3, 2, 1, 0)
    with pytest.raises(ValueError, match="leaf 3 of 5 dims"):
        AK.dynamic_table(trees)


# -- the kernel's passes, emulated on the table -------------------------------

def emulate(opt, table, params, grads, m, v, step, lr, commit):
    """The kernel's three passes over `table`, item by item, in torch f32
    on the CPU: (params, exp_avg, exp_avg_sq) as flat-buffer views."""
    li, lf = table.leaves_i, table.leaves_f
    b1, b2 = opt.betas
    nan = float("nan")
    p_out, m_out, v_out, q_out = (torch.full((table.total,), nan)
                                  for _ in range(4))
    partials = torch.full((table.partials, 4), nan)
    rowcoef = torch.full((table.rowcoefs, 2), nan)
    leafcoef = {}
    flat = [[t.reshape(-1) for t in tree] for tree in (params, grads, m, v)]
    t = (step + 1).to(torch.float32)
    bc1, sbc2 = 1 - b1 ** t, torch.sqrt(1 - b2 ** t)
    keep = bool(commit) if commit is not None else True

    def scalars(leaf):
        lr_leaf = lr * float(lf[leaf, AK.LR_SCALE])
        return lr_leaf, -lr_leaf / bc1

    def moments(leaf, idx):
        pp, gg, mm, vv = (f[leaf][idx] for f in flat)
        m2 = b1 * mm + (1 - b1) * gg
        v2 = b2 * vv + (1 - b2) * gg * gg
        den = torch.sqrt(v2) / sbc2 + opt.eps
        q = (b1 * m2 + (1 - b1) * gg if opt.nesterov else m2) / den
        return pp, gg, mm, vv, m2, v2, q

    def finish(leaf, pp, q, wd):
        lr_leaf, a = scalars(leaf)
        u = a * q
        if lf[leaf, AK.WEIGHT_DECAY] > 0:
            u = u - lr_leaf * float(lf[leaf, AK.WEIGHT_DECAY]) * wd * pp
        return pp + u if keep else pp

    def sums(gg, pp, q):
        return torch.stack([torch.sum(gg * gg, -1), torch.sum(gg * pp, -1),
                            torch.sum(pp * pp, -1), torch.sum(pp * q, -1)],
                           -1)

    for leaf, kind, x, y, part in table.items_a.tolist():
        numel, off, rows, length, *_, mode = li[leaf].tolist()
        idx = (torch.arange(x, x + y) if kind == 0
               else torch.arange(x * length, (x + y) * length))
        pp, gg, mm, vv, m2, v2, q = moments(leaf, idx)
        m_out[off + idx] = m2 if keep else mm
        v_out[off + idx] = v2 if keep else vv
        if mode == 0:
            p_out[off + idx] = finish(leaf, pp, q, 1.0)
            continue
        q_out[off + idx] = q
        if kind == 0:
            partials[part] = sums(gg, pp, q)
        else:
            partials[part:part + y] = sums(*(a.reshape(y, length)
                                             for a in (gg, pp, q)))
    for leaf in table.rlist.tolist():
        numel, off, rows, length, pbase, nsl, rbase, mode = li[leaf].tolist()
        rs = partials[pbase:pbase + rows * nsl].reshape(rows, nsl, 4).sum(1)
        cos = torch.abs(rs[:, 1]) / torch.clamp(
            torch.sqrt(rs[:, 0]) * torch.sqrt(rs[:, 2]), min=opt.eps)
        tot = rs.sum(0)
        kind = 1
        if mode == 2:
            ly = torch.abs(tot[1]) / torch.clamp(
                torch.sqrt(tot[0]) * torch.sqrt(tot[2]), min=opt.eps)
            kind = (1 if torch.max(cos) < float(lf[leaf, AK.THR_CH])
                    else 2 if ly < float(lf[leaf, AK.THR_LY]) else 0)
        n = torch.sqrt(tot[2]) + opt.eps
        leafcoef[leaf] = (kind, opt.wd_ratio if kind else 1.0, n, tot[3] / n)
        if kind == 1:
            nr = torch.sqrt(rs[:, 2]) + opt.eps
            rowcoef[rbase:rbase + rows] = torch.stack([nr, rs[:, 3] / nr], 1)
    for leaf, x, y in table.items_b.tolist():
        numel, off, rows, length, pbase, nsl, rbase, mode = li[leaf].tolist()
        kind, wd, n, k = leafcoef[leaf]
        idx = torch.arange(x, x + y)
        pp, q = flat[0][leaf][idx], q_out[off + idx]
        if kind == 1:
            c = rowcoef[rbase + idx // length]
            n, k = c[:, 0], c[:, 1]
        out = q if kind == 0 else q - (pp / n) * k
        p_out[off + idx] = finish(leaf, pp, out, wd)
    return [[buf.as_strided(s, st, o) for s, st, o in table.views]
            for buf in (p_out, m_out, v_out)]


def plain_commit(opt, grads, state, params, lr, commit):
    """`update` and the masked commit, as the train step had them."""
    upd, new = opt.update(grads, state, params, lr)
    if commit is None:
        return P.tree_map(lambda p, u: p + u, params, upd), new
    return (P.tree_map(lambda p, u: torch.where(commit, p + u, p), params,
                       upd),
            P.tree_map(lambda a, b: torch.where(commit, a, b), new, state))


def gate_branches_clear(opt, grads, params):
    """Every data-dependent gate held clear of its threshold, and each
    branch taken by its leaf."""
    rep = opt.gate_report(grads, params)
    for path, (ch, ch_t, ly, ly_t) in rep.items():
        assert abs(ch - ch_t) > GATE_MARGIN * ch_t, path
        assert abs(ly - ly_t) > GATE_MARGIN * ly_t, path
    ch, ch_t, _, _ = rep["ortho"]
    assert ch < ch_t
    ch, ch_t, ly, ly_t = rep["layer"]
    assert ch >= ch_t and ly < ly_t
    ch, ch_t, ly, ly_t = rep["free"]
    assert ch >= ch_t and ly >= ly_t


CASES = [("AdamP", False, 1e-3, True), ("AdamP", True, 1e-3, True),
         ("AdamP", False, 0.0, True), ("Adam", False, 1e-3, True),
         ("AdamP", False, 1e-3, False)]


@pytest.mark.parametrize("name,nesterov,wd,commit", CASES)
def test_emulated_passes_match_plain(name, nesterov, wd, commit):
    opt = make(name, nesterov, wd)
    params, grads = gate_tree(scale=2)
    tp, tg = to_t(params), to_t(grads)
    if name == "AdamP":
        gate_branches_clear(opt, tg, tp)
    fp = P.flatten(tp)
    table = AK.build_table([tuple(t.shape) for t in fp.values()],
                           [opt.resolved_options(k) for k in fp], opt.delta)
    st_p = st_e = opt.init(tp)
    pp = pe = tp
    flag = torch.tensor(commit)
    for k in range(2):
        lr = torch.tensor(1e-2 * (k + 1))
        pp, st_p = plain_commit(opt, tg, st_p, pp, lr, flag)
        new = emulate(opt, table, flat_list(pe), flat_list(tg),
                      flat_list(st_e.exp_avg), flat_list(st_e.exp_avg_sq),
                      st_e.step, lr, flag)
        keys = list(fp)
        pe = P.unflatten(dict(zip(keys, new[0])))
        st_e = TO.AdamPState(st_e.step + int(commit),
                             P.unflatten(dict(zip(keys, new[1]))),
                             P.unflatten(dict(zip(keys, new[2]))))
        for got, ref in ((pe, pp), (st_e.exp_avg, st_p.exp_avg),
                         (st_e.exp_avg_sq, st_p.exp_avg_sq)):
            fr = P.flatten(ref)
            for key, g in P.flatten(got).items():
                np.testing.assert_allclose(g.numpy(), fr[key].numpy(),
                                           rtol=1e-5, atol=1e-8,
                                           err_msg=f"step {k} {key}")
        assert int(st_e.step) == int(st_p.step)


# -- AdamP.apply: the dispatch and the plain branch ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_f64_trees_take_the_plain_path(dtype):
    opt = make()
    params, grads = gate_tree()
    tp, tg = to_t(params, dtype=dtype), to_t(grads, dtype=dtype)
    before = TO.fused_record()
    launches = AK.LAUNCHES[AK.KERNEL]
    opt.apply(tg, opt.init(tp), tp, torch.tensor(1e-3), torch.tensor(True))
    after = TO.fused_record()
    assert after["plain"] - before["plain"] == len(P.flatten(tp))
    assert after["fused"] == before["fused"]
    assert AK.LAUNCHES[AK.KERNEL] == launches
    assert opt._tables == {}


def _faulty(fault):
    """Flat (params, grads, exp_avg, exp_avg_sq) and step with one fault."""
    params, grads = gate_tree()
    fp, fg = P.flatten(to_t(params)), P.flatten(to_t(grads))
    trees = [fp, fg, dict(fg), dict(fg)]
    step = torch.zeros((), dtype=torch.int32)
    if fault == "f64 leaf":
        trees[2]["free"] = trees[2]["free"].double()
    elif fault == "shape":
        trees[1]["bias"] = trees[1]["bias"][:-1]
    elif fault == "missing leaf":
        del trees[3]["gain"]
    elif fault == "order":
        trees[1] = dict(reversed(list(fg.items())))
    elif fault == "step device":
        step = torch.zeros((), dtype=torch.int32, device="meta")
    return tuple(trees), step


@pytest.mark.parametrize("fault,message", [
    ("f64 leaf", "exp_avg leaf free is torch.float64"),
    ("shape", r"grads leaf bias is torch.float32 \(4,\)"),
    ("missing leaf", r"exp_avg_sq tree's leaves differ .*'gain'"),
    ("order", "grads tree's leaves differ .*their order"),
    ("step device", "step on meta")])
def test_kernel_trees_refused_by_leaf(fault, message):
    """A tree the kernel cannot take is refused, naming the leaf, never
    sent to the plain path."""
    TO._check_kernel_trees(*_faulty(None))
    with pytest.raises(ValueError, match=message):
        TO._check_kernel_trees(*_faulty(fault))


@pytest.mark.parametrize("commit", [True, False, None])
def test_apply_plain_equals_update_and_masked_commit(commit):
    opt = make(nesterov=True)
    params, grads = gate_tree()
    tp, tg = to_t(params), to_t(grads)
    flag = None if commit is None else torch.tensor(commit)
    st = opt.init(tp)
    # a state past its first step, so that the moments are not zeros
    tp, st = opt.apply(tg, st, tp, torch.tensor(1e-3))
    frozen = P.tree_map(torch.clone, (tp, st))
    got_p, got_s = opt.apply(tg, st, tp, torch.tensor(2e-3), flag)
    ref_p, ref_s = plain_commit(opt, tg, st, tp, torch.tensor(2e-3), flag)
    for got, ref in ((got_p, ref_p), (got_s, ref_s)):
        fr = P.flatten(ref)
        for key, g in P.flatten(got).items():
            assert torch.equal(g, fr[key]), key
    # the inputs are left as they were
    for a, b in zip(P.flatten((tp, st)).values(),
                    P.flatten(frozen).values()):
        assert torch.equal(a, b)
    if commit is False:
        for a, b in zip(P.flatten((got_p, got_s)).values(),
                        P.flatten((tp, st)).values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["SGDP", "RAdam"])
def test_other_optimizers_apply_on_the_plain_path(name):
    kw = {"lr": 1e-3, "weight_decay": 1e-3}
    if name == "SGDP":
        kw["momentum"] = 0.9
    opt = TO.make_optimizer(name, kw)[0]
    params, grads = gate_tree()
    tp, tg = to_t(params), to_t(grads)
    st = opt.init(tp)
    flag = torch.tensor(False)
    before = TO.fused_record()["plain"]
    got_p, got_s = opt.apply(tg, st, tp, torch.tensor(1e-3), flag)
    assert TO.fused_record()["plain"] - before == len(P.flatten(tp))
    ref_p, ref_s = plain_commit(opt, tg, st, tp, torch.tensor(1e-3), flag)
    for a, b in zip(P.flatten((got_p, got_s)).values(),
                    P.flatten((ref_p, ref_s)).values()):
        assert torch.equal(a, b)


# -- on the card ---------------------------------------------------------------

def _leaf_gap(got, ref):
    return float(torch.linalg.vector_norm((got - ref).double())
                 / max(float(torch.linalg.vector_norm(ref.double())), 1e-30))


def strided_grads(grads):
    """The tree with two gradients in other layouts: a weight gradient
    channels-last, as cuDNN may give it, and a transposed one."""
    grads["big"]["conv"] = grads["big"]["conv"].contiguous(
        memory_format=torch.channels_last)
    grads["free"] = grads["free"].t().contiguous().t()
    assert not grads["big"]["conv"].is_contiguous()
    assert not grads["free"].is_contiguous()
    return grads


@pytest.mark.card
@pytest.mark.parametrize("name,nesterov,wd,commit", CASES)
def test_kernel_matches_plain_on_card(card, name, nesterov, wd, commit):
    opt = make(name, nesterov, wd)
    params, grads = gate_tree(scale=4)
    tp, tg = to_t(params, card), strided_grads(to_t(grads, card))
    if name == "AdamP":
        gate_branches_clear(opt, tg, tp)
    flag = torch.tensor(commit, device=card)
    st_k = st_p = opt.init(tp)
    pk = pp = tp
    for k in range(2):
        lr = torch.full((), 1e-2 * (k + 1), device=card)
        fused = TO.fused_record()["fused"]
        pk, st_k = opt.apply(tg, st_k, pk, lr, flag)
        assert TO.fused_record()["fused"] - fused == len(P.flatten(tp))
        pp, st_p = plain_commit(opt, tg, st_p, pp, lr, flag)
        assert int(st_k.step) == int(st_p.step) == (k + 1 if commit else 0)
        for what, got, ref in (("params", pk, pp),
                               ("exp_avg", st_k.exp_avg, st_p.exp_avg),
                               ("exp_avg_sq", st_k.exp_avg_sq,
                                st_p.exp_avg_sq)):
            fr = P.flatten(ref)
            for key, g in P.flatten(got).items():
                assert _leaf_gap(g, fr[key]) <= 1e-5, (k, what, key)
        if not commit:
            for a, b in zip(flat_list((pk, st_k.exp_avg, st_k.exp_avg_sq)),
                            flat_list((tp, st_p.exp_avg, st_p.exp_avg_sq))):
                assert torch.equal(a, b)
    # the updates themselves (params after minus before), leaf by leaf
    if commit:
        fk, fp0, fpp = P.flatten(pk), P.flatten(tp), P.flatten(pp)
        for key in fp0:
            assert _leaf_gap(fk[key] - fp0[key],
                             fpp[key] - fp0[key]) <= 1e-4, key


@pytest.mark.card
def test_kernel_launches_and_repeats_bitwise_on_card(card):
    opt = make()
    params, grads = gate_tree(scale=4)
    tp, tg = to_t(params, card), strided_grads(to_t(grads, card))
    st = opt.init(tp)
    tp, st = opt.apply(tg, st, tp, torch.full((), 1e-3, device=card))
    lr = torch.full((), 2e-3, device=card)
    flag = torch.tensor(True, device=card)
    torch.cuda.synchronize()
    launches = AK.LAUNCHES[AK.KERNEL]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        a = opt.apply(tg, st, tp, lr, flag)
        torch.cuda.synchronize()
    assert AK.LAUNCHES[AK.KERNEL] - launches == 3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {e.name for e in kernels}
    # 3 passes and the pointer table's copy: no copy of a strided leaf
    assert len(kernels) <= 4, sorted(names)
    assert any("adamp_pass_a" in n for n in names), sorted(names)
    for _ in range(3):
        b = opt.apply(tg, st, tp, lr, flag)
        for x, y in zip(P.flatten(a).values(), P.flatten(b).values()):
            assert torch.equal(x, y)


@pytest.mark.card
def test_card_tree_the_kernel_cannot_take_is_refused(card):
    """A CUDA tree with an f64 leaf raises, naming the leaf, and launches
    nothing: the plain path is the CPU's alone."""
    opt = make()
    params, grads = gate_tree()
    tp, tg = to_t(params, card), to_t(grads, card)
    st = opt.init(tp)
    tg["free"] = tg["free"].double()
    launches = AK.LAUNCHES[AK.KERNEL]
    plain = TO.fused_record()["plain"]
    with pytest.raises(ValueError, match="grads leaf free is torch.float64"):
        opt.apply(tg, st, tp, torch.full((), 1e-3, device=card))
    assert AK.LAUNCHES[AK.KERNEL] == launches
    assert TO.fused_record()["plain"] == plain
