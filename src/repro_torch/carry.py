"""Carry a graph, a compiled plan or a model's weights across from the JAX
package.

The reference's ``ExecutionGraph``, ``CompiledPlan``, ``MultiPlan`` and
``SparsePlan`` are
plain numpy fields; passing those fields here as a dict of arrays rebuilds
the same objects in this package without importing ``repro``.  The parity tests use
it to feed both engines the identical plan — this system's counterpart of
carrying weights across.  :func:`model_params_from_arrays` carries the
model stack's parameter tree itself.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.sweep.compile import (SPARSE_ARRAYS, CompiledPlan, MultiPlan,
                                      SparsePlan)

GRAPH_ARRAYS = {
    "kind": np.int8, "vcost": np.float64, "vrank": np.int32,
    "esrc": np.int32, "edst": np.int32, "econst": np.float64,
    "ebytes": np.float64, "elat": np.int16, "egap": np.float64,
    "egclass": np.int32, "elink": np.int32, "link_classes": np.int32,
    "in_ptr": np.int64, "in_edge": np.int32, "level": np.int32,
}

PLAN_ARRAYS = {
    "esrc": np.int32, "edstl": np.int32, "emask": bool,
    "econst": np.float64, "egap": np.float64, "egclass": np.int32,
    "elat": np.float64, "vcost_lv": np.float64, "valid_flat": bool,
    "vert_of_slot": np.int32,
}

#: a compiled plan's edge-position records (original edge order)
EPOS_ARRAYS = ("epos_lvl", "epos_dst", "epos_e")


def _take(fields: Dict[str, np.ndarray], spec: dict, optional=()) -> dict:
    missing = [k for k in spec if k not in fields and k not in optional]
    if missing:
        raise ValueError(f"missing array fields {missing}")
    return {k: (np.array(fields[k], dtype=dt) if fields.get(k) is not None
                else None)
            for k, dt in spec.items() if k in fields}


def graph_from_arrays(fields: Dict[str, np.ndarray], nclass: int,
                      nranks: int, nlevels: int,
                      nlinks: int = 0) -> ExecutionGraph:
    """An :class:`ExecutionGraph` from the reference graph's array fields
    (``egap``/``egclass``/``elink``/``link_classes`` may be absent)."""
    arrs = _take(fields, GRAPH_ARRAYS,
                 optional=("egap", "egclass", "elink", "link_classes"))
    if arrs["elat"].shape != (arrs["esrc"].shape[0], nclass):
        raise ValueError(f"elat is {arrs['elat'].shape}, expected "
                         f"({arrs['esrc'].shape[0]}, {nclass})")
    g = ExecutionGraph(**arrs, nclass=int(nclass), nranks=int(nranks),
                       nlevels=int(nlevels), nlinks=int(nlinks))
    g.validate()
    return g


def plan_from_arrays(fields: Dict[str, np.ndarray], nv: int, nclass: int,
                     nlevels: int) -> CompiledPlan:
    """A :class:`CompiledPlan` from the reference plan's array fields.

    Besides the dense view's arrays, ``fields`` must hold the reference's
    per-vertex ``vsrc`` [nlv_p, Vmax, Dmax], whose width the dense-size
    guard counts.  The edge-position records (``epos_lvl``, ``epos_dst``,
    ``epos_e``), which cost and structure patches need, are carried when
    ``fields`` holds them, and so are the link records the congestion
    fixed point reads (``elinkp`` with ``link_classes``, whose length is
    ``nlinks``)."""
    arrs = _take(fields, PLAN_ARRAYS)
    epos = {k: np.array(fields[k], dtype=np.int32) for k in EPOS_ARRAYS
            if fields.get(k) is not None}
    if epos and set(epos) != set(EPOS_ARRAYS):
        raise ValueError(f"the edge-position records come together: got "
                         f"{sorted(epos)} of {list(EPOS_ARRAYS)}")
    if len({a.shape for a in epos.values()}) > 1:
        raise ValueError("the edge-position records differ in length")
    if "vsrc" not in fields:
        raise ValueError("missing array field 'vsrc' (for Dmax)")
    nlv_p, Emax = arrs["esrc"].shape
    Vmax = arrs["vcost_lv"].shape[1]
    want = {"edstl": (nlv_p, Emax), "emask": (nlv_p, Emax),
            "econst": (nlv_p, Emax), "egap": (nlv_p, Emax),
            "egclass": (nlv_p, Emax), "elat": (nlv_p, Emax, nclass),
            "vcost_lv": (nlv_p, Vmax), "valid_flat": (nlv_p * Vmax + 1,),
            "vert_of_slot": (nlv_p * Vmax + 1,)}
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise ValueError(f"{k} is {arrs[k].shape}, expected {shape}")
    return CompiledPlan(**arrs, nv=int(nv), nclass=int(nclass),
                        nlevels=int(nlevels),
                        Dmax=int(np.shape(fields["vsrc"])[2]), **epos,
                        **_links(fields, "elinkp", (nlv_p, Emax)))


def _links(fields: Dict[str, np.ndarray], name: str, shape: tuple) -> dict:
    """The link records of a plan's fields: the per-edge ids ``name`` (in
    the dummy bin ``nlinks`` where an edge has no link) with
    ``link_classes``, or nothing when ``fields`` carries no ids."""
    if fields.get(name) is None:
        return {}
    ids = np.array(fields[name], dtype=np.int32)
    classes = np.array(fields.get("link_classes", np.zeros(0)),
                       dtype=np.int32).reshape(-1)
    if ids.shape != shape:
        raise ValueError(f"{name} is {ids.shape}, expected {shape}")
    if ids.size and not 0 <= ids.min() <= ids.max() <= classes.shape[0]:
        raise ValueError(f"{name} holds ids outside [0, nlinks = "
                         f"{classes.shape[0]}]")
    return {name: ids, "nlinks": int(classes.shape[0]),
            "link_classes": classes}


def multi_plan_from_arrays(fields: Dict[str, np.ndarray], nv, nlevels,
                           nclass: int, Dmax: int) -> MultiPlan:
    """A :class:`MultiPlan` from the reference multi-plan's dense-view
    array fields (its per-vertex arrays and ``plan_hashes`` are not
    carried; ``Dmax`` is the width of its ``vsrc``).  ``nv`` and
    ``nlevels`` are per graph.  Raises ``ValueError`` on a missing field or
    a wrong shape."""
    arrs = _take(fields, PLAN_ARRAYS)
    G, nlv_p, Emax = arrs["esrc"].shape
    Vmax = arrs["vcost_lv"].shape[2]
    nv = np.asarray(nv, dtype=np.int64).reshape(-1)
    nlevels = np.asarray(nlevels, dtype=np.int64).reshape(-1)
    want = {"edstl": (G, nlv_p, Emax), "emask": (G, nlv_p, Emax),
            "econst": (G, nlv_p, Emax), "egap": (G, nlv_p, Emax),
            "egclass": (G, nlv_p, Emax), "elat": (G, nlv_p, Emax, nclass),
            "vcost_lv": (G, nlv_p, Vmax),
            "valid_flat": (G, nlv_p * Vmax + 1),
            "vert_of_slot": (G, nlv_p * Vmax + 1)}
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise ValueError(f"{k} is {arrs[k].shape}, expected {shape}")
    if nv.shape != (G,) or nlevels.shape != (G,):
        raise ValueError(f"nv and nlevels need one entry per graph ({G}), "
                         f"got {nv.shape} and {nlevels.shape}")
    if (nlevels > nlv_p).any():
        raise ValueError(f"nlevels {nlevels.tolist()} exceed nlv_p {nlv_p}")
    return MultiPlan(**arrs, nv=nv, nlevels=nlevels, nclass=int(nclass),
                     Dmax=int(Dmax))


SPARSE_PLAN_ARRAYS = dict(zip(SPARSE_ARRAYS, (
    np.int32, np.int32, bool, np.float64, np.float64, np.int32, np.float64,
    np.float64, np.float64, bool, np.int32, np.int32, np.int32)))


def sparse_plan_from_arrays(fields: Dict[str, np.ndarray], nv: int, ne: int,
                            nclass: int, nlevels: int, Emax_lv: int,
                            Vmax_lv: int) -> SparsePlan:
    """A :class:`SparsePlan` from the reference sparse plan's array fields
    (with its ``elink``/``link_classes`` when present).  Raises
    ``ValueError`` on a missing field or a wrong shape; the padding
    invariants are checked where the plan is staged."""
    arrs = _take(fields, SPARSE_PLAN_ARRAYS)
    ne_p = arrs["esrc_slot"].shape[0]
    nv_p = arrs["vcost"].shape[0]
    nlv_p = arrs["level_ptr"].shape[0] - 1
    want = {"esrc_slot": (ne_p,), "edst_slot": (ne_p,), "emask": (ne_p,),
            "econst": (ne_p,), "egap": (ne_p,), "egclass": (ne_p,),
            "elat": (ne_p, nclass), "elat_sum": (ne_p,), "vcost": (nv_p,),
            "valid": (nv_p,), "vert_of_slot": (nv_p,),
            "level_ptr": (nlv_p + 1,), "v_ptr": (nlv_p + 1,)}
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise ValueError(f"{k} is {arrs[k].shape}, expected {shape}")
    return SparsePlan(**arrs, nv=int(nv), ne=int(ne), nclass=int(nclass),
                      nlevels=int(nlevels), Emax_lv=int(Emax_lv),
                      Vmax_lv=int(Vmax_lv),
                      **_links(fields, "elink", (ne_p,)))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays → {"a.b.c": array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor with the same bits (bfloat16 arrays,
    which numpy holds as ``ml_dtypes.bfloat16``, by way of uint16)."""
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def model_params_from_arrays(cfg: ModelConfig, tree: dict,
                             device: DeviceLike = None) -> Model:
    """A :class:`Model` whose parameters equal, bit for bit, the reference's
    parameter tree given as numpy arrays (``init_params``'s structure:
    ``embed``, ``final_norm``, ``lm_head``, ``prefix`` [per layer] and
    ``period`` [per position of a scan period, stacked over ``n_periods``]).
    Absolute layer ``n_prefix_layers + p·period_len + li`` is period ``p``
    of ``period[li]``; jamba's period is 8 layers (lcm of its 8-block
    pattern and MoE every 2nd layer), its Mamba and MoE leaves included.
    Raises ``ValueError`` on a missing, extra or mis-shaped leaf, or a
    dtype other than the model's parameter's (float32 for the leaves the
    reference keeps in float32 in any model: Mamba's ``dt_bias``,
    ``A_log`` and ``D``, the MoE ``router``, RWKV-6's ``decay_base`` and
    ``bonus_u``).  MLA's, RWKV-6's and its channel mix's, the GELU MLP's
    and LayerNorm's leaves carry under the reference's names."""
    model = Model(cfg, device=device)
    flat = _flatten({k: tree[k] for k in ("embed", "final_norm", "lm_head")
                     if k in tree})
    for i, blk in enumerate(tree.get("prefix", ())):
        flat.update(_flatten(blk, f"blocks.{i}."))
    n0, plen = cfg.n_prefix_layers, cfg.period_len
    period = tree.get("period", ())
    if len(period) != plen:
        raise ValueError(f"the tree has {len(period)} period positions, "
                         f"{cfg.name} has {plen}")
    for li, stacked in enumerate(period):
        for name, a in _flatten(stacked).items():
            if a.shape[0] != cfg.n_periods:
                raise ValueError(f"period[{li}].{name} stacks {a.shape[0]} "
                                 f"periods, {cfg.name} has {cfg.n_periods}")
            for p in range(cfg.n_periods):
                flat[f"blocks.{n0 + p * plen + li}.{name}"] = a[p]
    state = model.state_dict()
    if set(flat) != set(state):
        raise ValueError(f"missing leaves {sorted(set(state) - set(flat))}, "
                         f"extra leaves {sorted(set(flat) - set(state))}")
    for name, a in flat.items():
        t = _tensor(a)
        if t.shape != state[name].shape or t.dtype != state[name].dtype:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, the "
                             f"model's is {tuple(state[name].shape)} "
                             f"{state[name].dtype}")
        state[name].copy_(t)
    return model
