"""LLAMP's latency analysis in PyTorch, with hand-written CUDA kernels for
the H100 — the port of the JAX package ``repro``, which stays the
reference — and the serving path of its LLM model stack (dense GQA,
MoE and the Mamba hybrid, on the flash-attention and linear-scan
kernels).

The port keeps the reference's module paths (``repro_torch.core.synth``
↔ ``repro.core.synth``, ``repro_torch.sweep.engine`` ↔
``repro.sweep.engine``, ``repro_torch.kernels.maxplus`` ↔
``repro.kernels.maxplus``, ``repro_torch.models.layers`` ↔
``repro.models.layers``) and imports neither ``jax`` nor ``repro``.
Entry points run on the CUDA card unless given ``device="cpu"``.

    from repro_torch.core import synth, sensitivity
    from repro_torch.core.loggps import cluster_params
    p = cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(4, 4, 10, params=p)
    curve = sensitivity.latency_curve(g, p, deltas)       # on the card
    tol = sensitivity.latency_tolerance(g, p, device="cpu")

    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params
    model = init_params(configs.get("llama3.2-3b")[0], seed=0)   # on the card
    tokens = generate(model, prompts, gen=64).tokens
"""

from . import (carry, configs, core, device, kernels, models,  # noqa: F401
               runtime, sweep)
