"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.

  maxplus/  — the dense (max,+) mat-vec and its argmax-emitting twin,
              both also batched over a leading graph axis: one
              topological level of the LLAMP forward (dense and packed
              multi-graph backends), scenarios on the contiguous axis;
              the slot-list (max,+) segment reduction with argmax; the
              level loops of the dense, sparse and segment forwards and
              the critical-path backtrace.
  flash_attention/ — blocked online-softmax attention with the causal and
              kv_len masks and GQA head sharing: the model stack's
              attention core, in prefill and in decode against a KV
              cache.
  linear_scan/ — the diagonal linear recurrence h_t = a_t ⊙ h_{t−1} + b_t
              with its read-out y_t = Σ_s h_t · c_t; and the Mamba scan,
              which forms a = exp(dt·A) and b = (dt·x)·B itself and adds
              the skip x·D: the Mamba blocks' whole scan in one launch,
              in prefill and one token a step in decode.
  rwkv/     — RWKV-6's time-mix recurrence (wkv6): a head's state
              [hd, hd] carried on chip through a layer's whole sequence,
              in prefill and one token a step in decode.
  ipm/      — the tree preconditioner of the LP's sparse Newton solve:
              a forest's pivots and its up and down sweeps over the
              DAG's levels, one lane a right-hand side.

Sources live in ``*/csrc/`` and are built by :mod:`.build` on first use;
importing this package builds nothing.
"""
