"""Framework-step → execution-graph tracer (the liballprof+Schedgen role).

The paper traces MPI ranks; here the "application" is one sharded
train/decode step of an assigned architecture on a (pod, data, model) mesh.
The tracer emits, per device, the LogGPS op sequence the step executes:

  train:  per scan period —
            fwd calc → per-layer TP collectives (Megatron: 2 allreduce/layer,
            MoE: 2 all-to-alls over the EP group) → bwd calc (2×) →
            per-period FSDP gradient reduce-scatter (data axis, ring) →
            cross-pod gradient all-reduce (DCN class)
          epilogue: vocab-parallel logits all-reduce + optimizer calc.
  decode: per period — FSDP weight all-gather (data axis) + tiny calc +
          2 TP allreduces/layer; epilogue logits all-reduce.

Collective algorithms are selectable (ring / recursive_doubling / …) —
the Fig 10 case-study axis.  Latency classes come from the network-model
registry (`pod_model`): ("ici", "dcn") by default, or ("node", "ici",
"dcn") when ``ranks_per_host`` is set — the "node" class models the
intra-node fabric (NVLink/shared-memory) between same-host ranks.  The
reduced costs λ_L split per fabric, so tolerance queries can target DCN
(the FEC/cloud question the paper asks), ICI, or the intra-node class.

Compute-vertex costs come from the config's analytic FLOP model at a given
MFU guess — predictions are *model-relative*.

A numpy copy of the JAX package's ``repro/core/tracer.py`` on the PyTorch
package's ``models.config``: the same graphs, array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import collectives as coll
from .graph import ExecutionGraph, GraphBuilder
from .loggps import LogGPS, pod_model
from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class TraceSpec:
    pods: int = 1
    data: int = 16
    model: int = 16
    mfu: float = 0.5                   # compute-vertex efficiency guess
    allreduce_algo: str = "ring"       # TP/DP collective expansion (Fig 10 axis)
    dp_algo: str = "ring"
    peak_flops: float = 197e12
    bytes_per_elt: int = 2             # bf16 activations/grads
    ranks_per_host: Optional[int] = None  # set → emit the intra-node class

    @property
    def n_devices(self) -> int:
        return self.pods * self.data * self.model

    def device(self, p: int, d: int, m: int) -> int:
        return (p * self.data + d) * self.model + m

    def network_model(self, **kw):
        """The registry this spec traces against (see :func:`pod_model`)."""
        return pod_model(pod_size=self.data * self.model,
                         ranks_per_host=self.ranks_per_host, **kw)

    def params(self, **kw) -> LogGPS:
        return self.network_model(**kw).params()


def _model_groups(ts: TraceSpec):
    """Rank groups along the model axis (TP/EP groups)."""
    for p in range(ts.pods):
        for d in range(ts.data):
            yield [ts.device(p, d, m) for m in range(ts.model)]


def _data_groups(ts: TraceSpec):
    for p in range(ts.pods):
        for m in range(ts.model):
            yield [ts.device(p, d, m) for d in range(ts.data)]


def _pod_groups(ts: TraceSpec):
    if ts.pods == 1:
        return
    for d in range(ts.data):
        for m in range(ts.model):
            yield [ts.device(p, d, m) for p in range(ts.pods)]


def _calc_all(b: GraphBuilder, ts: TraceSpec, us: float):
    for r in range(ts.n_devices):
        b.add_calc(r, max(us, 1e-3))


def trace_train_step(cfg: ModelConfig, shape: ShapeConfig, ts: TraceSpec,
                     params: Optional[LogGPS] = None,
                     fwd_only: bool = False) -> ExecutionGraph:
    p = params or ts.params()
    b = GraphBuilder(ts.n_devices, p.nclass)

    B_local = shape.global_batch / (ts.pods * ts.data)
    tok_local = B_local * shape.seq_len
    D = cfg.d_model
    act_bytes = tok_local * D * ts.bytes_per_elt

    n_per = cfg.n_periods
    period_params = (cfg.active_param_count() - 2 * cfg.vocab * D) / cfg.n_layers \
        * cfg.period_len
    flops_fwd_dev = 2 * period_params / ts.model * tok_local
    t_fwd = flops_fwd_dev / (ts.peak_flops * ts.mfu) * 1e6    # µs
    grad_bytes = period_params / ts.model * ts.bytes_per_elt  # per model shard

    specs = cfg.period_specs()
    n_attn = sum(1 for s in specs if s[0] == "attn")
    n_mix_other = len(specs) - n_attn
    n_moe = sum(1 for s in specs if s[1] == "moe")
    n_dense_ffn = len(specs) - n_moe

    def tp_layer_collectives(scale: float):
        """One period's TP traffic: 2 allreduces per dense layer-part, MoE a2a."""
        n_ar = n_attn + n_mix_other + n_dense_ffn  # mixer out + dense ffn out
        for g in _model_groups(ts):
            for _ in range(int(np.ceil(n_ar * scale))):
                coll.allreduce(b, g, act_bytes, p, algo=ts.allreduce_algo)
            for _ in range(n_moe):
                coll.all_to_all(b, g, act_bytes * cfg.top_k, p)
                coll.all_to_all(b, g, act_bytes * cfg.top_k, p)

    # ---- forward + backward over periods -----------------------------------
    for it in range(n_per):
        _calc_all(b, ts, t_fwd)
        tp_layer_collectives(1.0)
    # logits + vocab-parallel CE
    _calc_all(b, ts, 2 * cfg.vocab * D / ts.model * tok_local
              / (ts.peak_flops * ts.mfu) * 1e6)
    for g in _model_groups(ts):
        coll.allreduce(b, g, tok_local * 8, p, algo=ts.allreduce_algo)
    if fwd_only:
        return b.finalize()
    for it in range(n_per):
        _calc_all(b, ts, 2 * t_fwd)
        tp_layer_collectives(2.0)
        # FSDP gradient reduce-scatter over the data axis (per period)
        for g in _data_groups(ts):
            coll.reduce_scatter(b, g, grad_bytes, p, algo=ts.dp_algo)
        # cross-pod gradient all-reduce (DCN) on the scattered shard
        for g in _pod_groups(ts):
            coll.allreduce(b, g, grad_bytes / ts.data, p,
                           algo="recursive_doubling" if ts.pods > 2 else "ring")
    # optimizer update
    _calc_all(b, ts, t_fwd * 0.05)
    return b.finalize()


def trace_decode_step(cfg: ModelConfig, shape: ShapeConfig, ts: TraceSpec,
                      params: Optional[LogGPS] = None) -> ExecutionGraph:
    p = params or ts.params()
    b = GraphBuilder(ts.n_devices, p.nclass)

    B_local = max(shape.global_batch / (ts.pods * ts.data), 1)
    D = cfg.d_model
    act_bytes = B_local * D * ts.bytes_per_elt
    n_per = cfg.n_periods
    period_params = (cfg.active_param_count() - 2 * cfg.vocab * D) / cfg.n_layers \
        * cfg.period_len
    w_shard_bytes = period_params / ts.model * ts.bytes_per_elt
    # decode flops: weights × 2 per token
    t_calc = (2 * period_params / ts.model * B_local
              / (ts.peak_flops * ts.mfu) * 1e6)
    specs = cfg.period_specs()
    n_ar = len(specs) + sum(1 for s in specs if s[1] != "moe")

    for it in range(n_per):
        # FSDP weight all-gather over data axis (ring)
        for g in _data_groups(ts):
            coll.all_gather(b, g, w_shard_bytes, p, algo=ts.dp_algo)
        _calc_all(b, ts, t_calc)
        for g in _model_groups(ts):
            for _ in range(n_ar):
                coll.allreduce(b, g, act_bytes, p, algo=ts.allreduce_algo)
    # logits
    for g in _model_groups(ts):
        coll.allreduce(b, g, B_local * 8, p, algo=ts.allreduce_algo)
    return b.finalize()


def trace_step(cfg: ModelConfig, shape: ShapeConfig, ts: TraceSpec,
               params: Optional[LogGPS] = None) -> ExecutionGraph:
    if shape.mode == "train":
        return trace_train_step(cfg, shape, ts, params)
    if shape.mode == "decode":
        return trace_decode_step(cfg, shape, ts, params)
    # prefill = forward pass only
    return trace_train_step(cfg, dataclasses.replace(shape, mode="train"),
                            ts, params, fwd_only=True)

