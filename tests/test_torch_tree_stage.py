"""The staged layout and the window rule of the tree kernels
(``repro_torch.kernels.ipm.stage``, ``csrc/tree_precond.cu``).

* The layout on ``random_forest``'s forests and on a small stencil LP's
  forest: the level table, ``wk == w[ch]``, ``gk == g[ch]``, and each
  level's children forming one run of ``ch``.
* The kernels' schedule run on the CPU: every operand read through the
  staged layout, every dependent value through a window of W slots under
  the rule of ``stage.up_hits`` / ``stage.down_hits`` (and from "device
  memory" otherwise), equal to ``tree_factor_ref`` and ``tree_solve_ref``
  bit for bit at windows from 1 slot to all positions.  A slot read by the
  rule but overwritten since would give another value.
* ``stage.window_misses`` against a direct count of child–parent
  distances.

The kernels themselves run only on the card
(``tests/test_torch_ipm_sparse.py``, marked ``gpu``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ipm, loggps, lp, synth
from repro_torch.kernels.ipm import stage, tree_factor_ref, tree_solve_ref
from test_torch_ipm_sparse import random_forest

WINDOWS = (1, 5, 37, 10 ** 6)


def stencil_forest(seed: int):
    """The preconditioner's forest of a small stencil's LP under a random
    positive d: (forest, diag)."""
    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(3, 3, 6, params=p)
    A, _, _ = ipm._fold_bounds(lp.build_lp(g, p))
    sn = ipm.SparseNewton(A, torch.device("cpu"), p.nclass)
    d = np.random.default_rng(seed).uniform(0.1, 10.0, A.shape[0])
    sn.form(torch.from_numpy(d))
    return sn.forest, sn.diag


def forests():
    for seed in range(3):
        f, diag, _ = random_forest(seed)
        yield f"random {seed}", f, diag
    f, diag, _ = random_forest(7, nv=60, nlv=60)     # one position a level
    yield "one a level", f, diag
    f, diag = stencil_forest(0)
    yield "stencil", f, diag


FORESTS = list(forests())
IDS = [name for name, _, _ in FORESTS]


@pytest.mark.parametrize("case", FORESTS, ids=IDS)
def test_staged_layout(case):
    _, f, diag = case
    lay = stage.factor_layout(f)
    assert stage.factor_layout(f) is lay               # once a forest
    lv = np.asarray(f.levels)
    ch_ptr, ch = f.ch_ptr.numpy(), f.ch.numpy()
    parent, w = f.parent.numpy(), f.w.numpy()
    tab = lay.lv_tab
    assert tab.dtype == torch.int32 and tab.shape == (f.nlv + 1, 2)
    np.testing.assert_array_equal(tab[:, 0].numpy(), lv)
    np.testing.assert_array_equal(tab[:, 1].numpy(), ch_ptr[lv])
    assert lay.width == -(-f.nv // f.nlv)
    assert stage.widest_level(f) == max(np.diff(lv))
    assert torch.equal(lay.wk, f.w[f.ch.long()])
    # each position's first two children, in list order, and w at them
    kids = [ch[ch_ptr[i]:ch_ptr[i + 1]].tolist() for i in range(f.nv)]
    want = np.array([(k + [-1, -1])[:2] for k in kids], dtype=np.int32)
    assert lay.c01.dtype == torch.int32
    np.testing.assert_array_equal(lay.c01.numpy(), want)
    np.testing.assert_array_equal(lay.w01.numpy(),
                                  np.where(want >= 0, w[want], 0.0))
    piv, g = tree_factor_ref(f, diag)
    gk, g01 = stage.solve_layout(f, g)
    assert torch.equal(gk, g[f.ch.long()])
    np.testing.assert_array_equal(g01.numpy(),
                                  np.where(want >= 0, g.numpy()[want], 0.0))
    assert stage.solve_layout(f, g)[0] is gk           # once a g
    # each level's children are one run of ch, in their parents' order
    for L in range(f.nlv):
        a, b = lv[L], lv[L + 1]
        run = ch[ch_ptr[a]:ch_ptr[b]]
        assert ((parent[run] >= a) & (parent[run] < b)).all()
        assert (np.diff(parent[run]) >= 0).all()
    assert sorted(ch.tolist()) == np.flatnonzero(parent >= 0).tolist()


def test_solve_layout_follows_g():
    f, diag, _ = random_forest(0)
    _, g = tree_factor_ref(f, diag)
    gk = stage.solve_layout(f, g)[0]
    g2 = g.clone()
    assert stage.solve_layout(f, g2)[0] is not gk      # another tensor
    g2.mul_(2.0)                                       # changed in place
    assert torch.equal(stage.solve_layout(f, g2)[0], g2[f.ch.long()])


def test_factor_layout_follows_w():
    f, _, _ = random_forest(1)
    lay = stage.factor_layout(f)
    f.w.mul_(3.0)                                      # changed in place
    lay2 = stage.factor_layout(f)
    assert lay2 is not lay
    assert torch.equal(lay2.wk, f.w[f.ch.long()])
    c = lay2.c01.long()
    assert torch.equal(lay2.w01, torch.where(c >= 0, f.w[c.clamp(min=0)],
                                             0.0))
    assert stage.factor_layout(f) is lay2


def staged_run(f, diag, r, W):
    """The kernels' schedule, level by level in numpy: (piv, g, x).
    Operands come from the staged layout; a child's (parent's) value from
    the window when the rule says so, else from the full arrays; a value
    goes to the window when the rule lets a later level read it.  A
    level's slots hold NaN while it reads: the kernel's threads write them
    as others read."""
    lay = stage.factor_layout(f)
    tab, wk, c01 = lay.lv_tab.numpy(), lay.wk.numpy(), lay.c01.numpy()
    ch_ptr, ch = f.ch_ptr.numpy(), f.ch.numpy()
    parent, w, d = f.parent.numpy(), f.w.numpy(), diag.numpy()
    up_hit, down_hit = stage.up_hits(f, W), stage.down_hits(f, W)
    nv, R = r.shape

    def up(out, win, first, v01, vk, term):
        """The factor's or the up sweep's levels: out[a:b] from first(a,
        b) and each child's term(coefficient, value), children in list
        order: the first two from the position's record (c01, v01), the
        rest from the child-order run (ch, vk)."""
        for L in reversed(range(f.nlv)):
            (a, e0), (b, e1) = tab[L], tab[L + 1]
            pos = np.arange(a, b)
            keep = pos - a < W                   # i < a + W
            win[pos[keep] % W] = np.nan          # written while it reads
            acc = first(a, b)
            cnt = ch_ptr[a + 1:b + 1] - ch_ptr[a:b]
            for j in range(int(cnt.max(initial=0))):
                rows = np.flatnonzero(cnt > j)
                k = ch_ptr[a + rows] + j
                assert ((k >= e0) & (k < e1)).all()
                if j < 2:
                    c, coef = c01[a + rows, j], v01[a + rows, j]
                else:
                    c, coef = ch[k], vk[k]
                hit = up_hit[k][:, None]
                val = np.where(hit, win[c % W], out[c])
                acc[rows] = term(coef[:, None], acc[rows], val)
            out[a:b] = acc
            win[pos[keep] % W] = acc[keep]

    # the factor: its own launch, its own window
    piv = np.full((nv, 1), np.nan)
    up(piv, np.full((W, 1), np.nan), lambda a, b: d[a:b, None].copy(),
       lay.w01.numpy(), wk, lambda wc, acc, pc: acc - (wc * wc) / pc)
    g = w / piv[:, 0]
    gk, g01 = (t.numpy() for t in stage.solve_layout(f, torch.from_numpy(g)))
    # the solve: the up sweep, then the down sweep on the same window
    x = np.full((nv, R), np.nan)
    win = np.full((W, R), np.nan)
    up(x, win, lambda a, b: r[a:b].copy(), g01, gk,
       lambda gc, acc, xc: acc + gc * xc)
    for L in range(f.nlv):
        a, b = tab[L, 0], tab[L + 1, 0]
        pos = np.arange(a, b)
        keep = b - pos <= W                      # i >= b - W
        win[pos[keep] % W] = np.nan
        v = x[a:b].copy()
        p = parent[a:b]
        kid = p >= 0
        hit = down_hit[a:b][kid][:, None]
        xp = np.where(hit, win[p[kid] % W], x[p[kid]])
        v[kid] = v[kid] + w[a:b][kid][:, None] * xp
        v = v / piv[a:b]
        x[a:b] = v
        win[pos[keep] % W] = v[keep]
    return piv[:, 0], g, x


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("case", FORESTS, ids=IDS)
def test_staged_schedule_equals_plain_versions(case, W):
    name, f, diag = case
    piv_r, g_r = tree_factor_ref(f, diag)
    R = 1 + len(name) % 3                         # 1, 2 and 3 lanes
    r = torch.from_numpy(np.random.default_rng(W).standard_normal((f.nv, R)))
    x_r = tree_solve_ref(f, piv_r, g_r, r)
    piv, g, x = staged_run(f, diag, r.numpy(), W)
    np.testing.assert_array_equal(piv, piv_r.numpy())
    np.testing.assert_array_equal(g, g_r.numpy())
    np.testing.assert_array_equal(x, x_r.numpy())


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("case", FORESTS, ids=IDS)
def test_window_misses_count_child_parent_distances(case, W):
    _, f, _ = case
    lv = list(f.levels)
    level = np.searchsorted(lv, np.arange(f.nv), side="right") - 1
    up = down = arcs = 0
    for v, p in enumerate(f.parent.tolist()):
        if p < 0:
            continue
        arcs += 1
        up += v - lv[level[p]] >= W              # past the parent level's a + W
        down += lv[level[v] + 1] - p > W         # before the child level's b - W
    got = stage.window_misses(f, W)
    assert got == {"arcs": arcs, "up": up, "down": down}
    if W >= f.nv:
        assert got["up"] == got["down"] == 0
