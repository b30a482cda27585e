"""The PyTorch package's model stack (dense, MoE and the Mamba hybrid,
serving path) against the JAX package's.

The same inputs, made with numpy, go through both; the JAX parameter tree
is carried across bit for bit (``repro_torch.carry.model_params_from_arrays``).
Tolerances: layers and the SMOKE forwards in float32 within 1e-4 (both
sides compute in float32; matmul and softmax sums run in another order on
each, observed ~3e-6 on logits of magnitude ~4, ~1.2e-5 on jamba's); the
Mamba block within 1e-5 (observed 1.2e-6 on outputs up to ~2); the MoE
block within 1e-6 of its largest output (the reference's expert weights
have fan-in E, so outputs reach ~500: observed 1.7e-7 of it); greedy
tokens equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import model_params_from_arrays
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import Model, init_params, layers as L
from repro_torch.models.ssm import Mamba
from repro_torch.runtime import build_prefill_step, build_serve_step

DENSE = ["llama3.2-3b", "yi-6b", "deepseek-7b", "minitron-8b"]
JAMBA, GROK = "jamba-1.5-large-398b", "grok-1-314b"
ATOL = 1e-4
MAMBA_ATOL = 1e-5
MOE_RTOL = 1e-6


@pytest.fixture(scope="module")
def jm():
    """The JAX package's model stack.  Imported here, not at the top: the
    machine with the card has no JAX."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.launch import serve as jserve
    from repro.models import layers as jlayers
    from repro.models import ssm as jssm
    return jax, jax.numpy, jconfigs, jmodels, jlayers, jserve, jssm


def _tree(jax, params):
    return jax.tree.map(np.asarray, params)


def _both(jm, arch, **changes):
    """(JAX SMOKE config, port SMOKE config), with the same changes."""
    jcfg = dataclasses.replace(jm[2].get(arch)[1], **changes)
    tcfg = dataclasses.replace(configs.get(arch)[1], **changes)
    return jcfg, tcfg


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.all_archs())
def test_configs_match_reference(arch, jm):
    jconfigs = jm[2]
    for mine, ref in zip(configs.get(arch), jconfigs.get(arch)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        for decode in (False, True):
            assert (mine.flops_per_token_fwd(4096, decode)
                    == ref.flops_per_token_fwd(4096, decode))
        assert [mine.layer_spec(i) for i in range(mine.n_layers)] == \
            [ref.layer_spec(i) for i in range(ref.n_layers)]
        assert mine.period_specs() == ref.period_specs()
        assert (mine.period_len, mine.n_periods) == (ref.period_len,
                                                     ref.n_periods)
        assert mine.torch_dtype == getattr(torch, ref.dtype)
    assert configs.shape_skips(configs.ALIASES[arch]) == \
        jconfigs.shape_skips(jconfigs.ALIASES[arch])


def test_registry_matches_reference(jm):
    jconfigs = jm[2]
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ALIASES == jconfigs.ALIASES
    assert configs.all_archs() == jconfigs.all_archs()


def test_shape_constants_match_reference(jm):
    from repro.models import config as jc

    from repro_torch.models import config as tc
    assert [dataclasses.asdict(s) for s in tc.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jc.ALL_SHAPES]


# -- carry ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_equals_tree_leaf_for_leaf(dtype, jm):
    """Layer L = p·period_len + li of the port is period p of the
    reference's ``period[li]``: 4 layers as 2 periods of 2."""
    jax = jm[0]
    jcfg, tcfg = _both(jm, "llama3.2-3b", n_layers=4, scan_period_multiplier=2,
                       dtype=dtype)
    assert (tcfg.period_len, tcfg.n_periods) == (2, 2)
    tree = _tree(jax, jm[3].init_params(jcfg, jax.random.key(3)))
    model = model_params_from_arrays(tcfg, tree, device="cpu")
    state = model.state_dict()
    assert len(state) == 3 + 4 * 9
    want_dtype = getattr(torch, dtype)

    def same(t, a):
        assert t.dtype == want_dtype
        bits = np.asarray(a).view(np.uint16 if dtype == "bfloat16" else
                                  np.uint32)
        tbits = t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        assert np.array_equal(tbits.numpy().view(bits.dtype), bits)

    same(state["embed"], tree["embed"])
    same(state["lm_head"], tree["lm_head"])
    same(state["final_norm.w"], tree["final_norm"]["w"])
    for p in range(2):
        for li in range(2):
            blk = tree["period"][li]
            for name, a in (("mixer.wq", blk["mixer"]["wq"]),
                            ("mixer.wo", blk["mixer"]["wo"]),
                            ("ffn.w_down", blk["ffn"]["w_down"]),
                            ("norm1.w", blk["norm1"]["w"])):
                same(state[f"blocks.{p * 2 + li}.{name}"], a[p])


def test_carry_layer_order_shows_in_the_forward(jm):
    """With the 2 × 2 period layout the carried model's logits equal the
    reference's; the same leaves with the two periods swapped do not."""
    jax, jnp = jm[0], jm[1]
    jcfg, tcfg = _both(jm, "llama3.2-3b", n_layers=4, scan_period_multiplier=2)
    params = jm[3].init_params(jcfg, jax.random.key(4))
    tree = _tree(jax, params)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 7))
    want, _, _ = jm[3].forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = model_params_from_arrays(tcfg, tree, device="cpu")(
        {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    swapped = dict(tree, period=tuple(jax.tree.map(lambda a: a[::-1], x)
                                      for x in tree["period"]))
    wrong, _ = model_params_from_arrays(tcfg, swapped, device="cpu")(
        {"tokens": torch.from_numpy(toks)})
    assert float((wrong - got).abs().max()) > 1e-2


def test_carry_rejects_a_tree_that_does_not_fit(jm):
    jax = jm[0]
    jcfg, tcfg = _both(jm, "llama3.2-3b")
    tree = _tree(jax, jm[3].init_params(jcfg, jax.random.key(0)))
    with pytest.raises(ValueError, match="missing leaves"):
        model_params_from_arrays(
            tcfg, {k: v for k, v in tree.items() if k != "lm_head"},
            device="cpu")
    with pytest.raises(ValueError, match="float32"):
        model_params_from_arrays(
            tcfg, dict(tree, embed=tree["embed"].astype(np.float64)),
            device="cpu")
    with pytest.raises(ValueError, match="stacks"):
        model_params_from_arrays(
            dataclasses.replace(tcfg, n_layers=4), tree, device="cpu")


# -- layers -----------------------------------------------------------------

def test_rms_and_layer_norm_match_reference(jm):
    jnp, jl = jm[1], jm[4]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(L.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5),
           jl.layer_norm(*(jnp.asarray(a) for a in (x, w, b)), 1e-5))


@pytest.mark.parametrize("sections", [None, (4, 6, 6)])
def test_apply_rope_matches_reference(sections, jm):
    """Plain RoPE on [B, T] positions and M-RoPE on [3, B, T] sections."""
    jnp, jl = jm[1], jm[4]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    shape = (2, 7) if sections is None else (3, 2, 7)
    pos = rng.integers(0, 500, shape)
    np.testing.assert_array_equal(L.rope_freqs(32, 5e5),
                                  jl.rope_freqs(32, 5e5))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5,
                        sections),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5, sections))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_matches_reference(causal, jm):
    """The port's attention core (the flash kernel's wrapper, its plain
    version here) against the reference's ``sdpa_simple`` and its chunked
    ``sdpa`` (Tk = 300 over chunks of 64: a padded last chunk)."""
    jnp, jl = jm[1], jm[4]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 300, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 300, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, jl.sdpa_simple(jq, jk, jv, causal))
    _close(got, jl.sdpa(jq, jk, jv, causal, chunk=64))


def test_attention_core_with_kv_len_matches_reference(jm):
    """One decode token against a 13-position cache holding 9 live keys,
    as the reference's unsharded ``decode_attention_sharded`` runs it."""
    jnp, jl = jm[1], jm[4]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False, kv_len=9)
    want = jl.decode_attention_sharded(*(jnp.asarray(a) for a in (q, k, v)),
                                       8, jnp.full((2,), 9))
    _close(got, want)


def _gqa(jm, tcfg, jcfg, seed):
    jax = jm[0]
    p = jm[4].gqa_init(jax.random.key(seed), jcfg, jcfg.jnp_dtype)
    blk = L.GQA(tcfg, device="cpu", dtype=torch.float32)
    for name in ("wq", "wk", "wv", "wo"):
        getattr(blk, name).copy_(torch.from_numpy(np.array(p[name])))
    return p, blk


def test_gqa_block_matches_reference(jm):
    """Without a cache (causal over T = 6), and with one: a decode token at
    cache_index 5 of a 13-position cache whose first 5 positions hold
    earlier keys."""
    jnp = jm[1]
    jcfg, tcfg = _both(jm, "llama3.2-3b")
    p, blk = _gqa(jm, tcfg, jcfg, seed=5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    want, _ = jm[4].gqa_apply(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, cache = blk(torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None
    _close(got, want)

    shape = (2, 13, tcfg.n_kv_heads, tcfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ck[:, 5:] = cv[:, 5:] = 0.0
    x1 = x[:, :1]
    pos1 = np.full((2, 1), 5)
    want, jc = jm[4].gqa_apply(p, jcfg, jnp.asarray(x1), jnp.asarray(pos1),
                               cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                               cache_index=5)
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, tc2 = blk(torch.from_numpy(x1), torch.from_numpy(pos1), tc, 5)
    assert tc2 is tc
    _close(got, want)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    with pytest.raises(ValueError, match="overruns"):
        blk(torch.from_numpy(x1), torch.from_numpy(pos1), tc, 13)


def test_swiglu_matches_reference(jm):
    jax, jnp, jl = jm[0], jm[1], jm[4]
    p = jl.swiglu_init(jax.random.key(6), 24, 40, jnp.float32)
    mlp = L.SwiGLU(24, 40, device="cpu", dtype=torch.float32)
    for name in ("w_gate", "w_up", "w_down"):
        getattr(mlp, name).copy_(torch.from_numpy(np.array(p[name])))
    x = np.random.default_rng(5).standard_normal((2, 3, 24)).astype(np.float32)
    _close(mlp(torch.from_numpy(x)), jl.swiglu_apply(p, jnp.asarray(x)))


# -- the model --------------------------------------------------------------

def _carried(jm, arch, seed=0, **changes):
    jax = jm[0]
    jcfg, tcfg = _both(jm, arch, **changes)
    params = jm[3].init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, params, model_params_from_arrays(
        tcfg, _tree(jax, params), device="cpu")


@pytest.mark.parametrize("arch", DENSE + [JAMBA, GROK])
def test_forward_and_decode_loop_match_reference(arch, jm):
    """Uncached forward over 9 tokens, then the decode-step loop over the
    same 9 tokens against a 12-position cache (jamba: a KV cache in its
    attention layer, the Mamba state in the other seven; grok: MoE on both
    layers)."""
    jnp, jmod = jm[1], jm[3]
    jcfg, tcfg, params, model = _carried(jm, arch)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 9))
    want, _, _ = jmod.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, cache = model({"tokens": torch.from_numpy(toks)})
    assert cache is None and got.shape == (2, 9, jcfg.vocab)
    _close(got, want)

    jcache = jmod.init_cache(jcfg, 2, 12)
    tcache = model.init_cache(2, 12)
    for t in range(9):
        tok = toks[:, t:t + 1]
        want1, jcache = jmod.decode_step(params, jcfg,
                                         {"tokens": jnp.asarray(tok)},
                                         jcache, t)
        got1, tcache = model.decode_step({"tokens": torch.from_numpy(tok)},
                                         tcache, t)
        _close(got1, want1)
    # the last decode step sees the whole prefix: the uncached forward's
    # last position
    _close(got1, got[:, -1].numpy())


def test_embeddings_in_with_mrope_match_reference(jm):
    """qwen2-vl-2b: precomputed embeddings in, [3, B, T] M-RoPE positions."""
    jnp, jmod = jm[1], jm[3]
    jcfg, tcfg, params, model = _carried(jm, "qwen2-vl-2b")
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 6))
    want, _, _ = jmod.forward(params, jcfg, {"embeds": jnp.asarray(emb),
                                             "positions": jnp.asarray(pos)})
    got, _ = model({"embeds": torch.from_numpy(emb),
                    "positions": torch.from_numpy(pos)})
    _close(got, want)
    want, _, _ = jmod.forward(params, jcfg, {"embeds": jnp.asarray(emb)})
    got, _ = model({"embeds": torch.from_numpy(emb)})
    _close(got, want)


def test_serve_and_prefill_steps(jm):
    _, tcfg, _, model = _carried(jm, "llama3.2-3b")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (2, 5)))
    logits, _ = model({"tokens": toks})
    assert torch.equal(build_prefill_step(tcfg)(model, {"tokens": toks}),
                       logits)
    cache = model.init_cache(2, 5)
    step = build_serve_step(tcfg)
    for t in range(5):
        last, cache = step(model, {"tokens": toks[:, t:t + 1]}, cache, t)
    _close(last, logits[:, -1].numpy())
    with pytest.raises(ValueError, match="built for"):
        build_serve_step(configs.get("yi-6b")[1])(model, {"tokens": toks[:, :1]},
                                                 cache, 0)


def test_serve_gives_the_reference_tokens(jm):
    """The port's serve loop on the JAX serve's parameters and prompts
    (carried) gives the tokens ``repro.launch.serve.main`` generated."""
    jax, jserve = jm[0], jm[5]
    argv = ["--arch", "llama3.2-3b", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "8", "--seed", "3"]
    want = np.asarray(jserve.main(argv))
    jcfg, tcfg, _, model = _carried(jm, "llama3.2-3b", seed=3)
    prompts = np.array(jax.random.randint(jax.random.key(1), (2, 8), 0,
                                            jcfg.vocab))
    res = serve.generate(model, torch.from_numpy(prompts), 8)
    assert res.tokens.shape == (2, 8)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_serve_main_runs_on_the_cpu():
    tokens = serve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "3",
                         "--prompt-len", "5", "--gen", "4", "--device", "cpu"])
    assert tokens.shape == (3, 4) and tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    again = serve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "3",
                        "--prompt-len", "5", "--gen", "4", "--device", "cpu"])
    assert torch.equal(tokens, again)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = configs.get("llama3.2-3b")[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3.2-3b", "--smoke"])


def test_serve_refuses_archs_without_a_decode_path():
    with pytest.raises(SystemExit, match="no autoregressive"):
        serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu"])


def test_cached_multi_token_forward_raises():
    """The serving path sends one token a step; a longer chunk against a
    cache is refused rather than answered differently from the reference
    or silently differently from the uncached forward."""
    model = init_params(configs.get("llama3.2-3b")[1], device="cpu")
    cache = model.init_cache(2, 16)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="one token a step"):
        model({"tokens": toks}, cache=cache, cache_index=0)


def test_reference_cached_multi_token_forward_is_not_causal(jm):
    """The reference quirk the port refuses: its cached forward over T = 8
    tokens attends to the whole chunk (``sdpa_simple(causal=False)``), so
    it differs from its own uncached forward."""
    jax, jnp, jmod = jm[0], jm[1], jm[3]
    jcfg = jm[2].get("llama3.2-3b")[1]
    params = jmod.init_params(jcfg, jax.random.key(0))
    toks = jnp.asarray(np.random.default_rng(10).integers(0, 512, (2, 8)))
    plain, _, _ = jmod.forward(params, jcfg, {"tokens": toks})
    cached, _, _ = jmod.forward(params, jcfg, {"tokens": toks},
                                cache=jmod.init_cache(jcfg, 2, 8),
                                cache_index=0)
    assert float(jnp.abs(plain - cached).max()) > 0.5
    # the last position sees the whole chunk either way, but its keys and
    # values came from positions that themselves saw the future
    assert float(jnp.abs(plain[:, -1] - cached[:, -1]).max()) > 0.1


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-7b",
                                  "hubert-xlarge"])
def test_mla_rwkv_and_encoder_configs_build(arch):
    """The three configs whose blocks came last build on the CPU: SMOKE
    drawn and run, and the full config's widths at two layers (allocated,
    not drawn), whose parameters are the config's ``param_count`` but for
    the vectors and the small factors it leaves out (norms, biases, RWKV's
    mixes, decay LoRA and bonus)."""
    full, smoke = configs.get(arch)
    model = init_params(smoke, device="cpu")
    x = ({"tokens": torch.zeros((1, 3), dtype=torch.int64)}
         if smoke.embed_input else {"embeds": torch.zeros((1, 3,
                                                           smoke.d_model))})
    assert model(x)[0].shape == (1, 3, smoke.vocab)
    cut = dataclasses.replace(full, n_layers=2)
    n = sum(p.numel() for p in Model(cut, device="cpu").parameters())
    assert cut.param_count() <= n <= 1.02 * cut.param_count()


def test_unknown_block_raises():
    cfg = configs.get("llama3.2-3b")[1]
    for bad in (dict(block_pattern=("conv",)), dict(ffn_type="relu"),
                dict(attn_type="linear")):
        with pytest.raises(ValueError):
            Model(dataclasses.replace(cfg, **bad), device="cpu")


# -- the hybrid: Mamba, MoE, their cache and carry ----------------------------

def _bits(x) -> np.ndarray:
    """The bits of a float32 or bfloat16 array or tensor, as numpy ints."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.name == "bfloat16" else np.int32)


def _leaves(tree, prefix=""):
    """Nested dicts of arrays → {"a.b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat_params(tree):
    """A (float32) parameter tree as a state dict."""
    return {k: torch.from_numpy(np.array(v)) for k, v in _leaves(tree).items()}


def _mamba(jm, seed, **changes):
    """(JAX config, the reference's Mamba parameters, the port's block
    holding them), float32."""
    jax, jnp = jm[0], jm[1]
    jcfg, tcfg = _both(jm, JAMBA, **changes)
    p = jm[6].mamba_init(jax.random.key(seed), jcfg, jnp.float32)
    blk = Mamba(tcfg, device="cpu", dtype=torch.float32)
    blk.load_state_dict(_flat_params(p))
    return jcfg, p, blk


@pytest.mark.parametrize("mode", ["scan", "chunked"])
def test_mamba_block_matches_reference(mode, jm):
    """Uncached over T = 18 against both of the reference's scan forms
    (chunked with ssm_chunk = 4: four whole chunks and a padded one); the
    port has one path, the linear scan, for both."""
    jnp = jm[1]
    jcfg, p, blk = _mamba(jm, seed=11, ssm_chunk=4)
    x = np.random.default_rng(11).standard_normal(
        (2, 18, jcfg.d_model)).astype(np.float32)
    want, wstate = jm[6].mamba_apply(p, jcfg, jnp.asarray(x), mode=mode)
    got, state = blk(torch.from_numpy(x))
    assert state is None and wstate is None
    _close(got, want, MAMBA_ATOL)


def test_mamba_decode_steps_match_reference(jm):
    """Cached: one token a step over five steps, then a 3-token chunk, from
    a random state, the conv window stitched from the cached tail; the new
    h and conv state match too."""
    jnp = jm[1]
    jcfg, p, blk = _mamba(jm, seed=12)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    Di = jcfg.ssm_expand * jcfg.d_model
    h0 = rng.standard_normal((2, Di, jcfg.ssm_state_dim)).astype(np.float32)
    conv0 = rng.standard_normal((2, jcfg.ssm_conv_dim - 1, Di)).astype(
        np.float32)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    tstate = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0)}
    for t0, t1 in ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 8)):
        want, jstate = jm[6].mamba_apply(p, jcfg, jnp.asarray(x[:, t0:t1]),
                                         state=jstate)
        got, tstate = blk(torch.from_numpy(x[:, t0:t1]), tstate)
        _close(got, want, MAMBA_ATOL)
        _close(tstate["h"], jstate["h"], MAMBA_ATOL)
        _close(tstate["conv"], jstate["conv"], MAMBA_ATOL)
        assert tstate["h"].dtype == torch.float32


def test_mamba_init_matches_reference(jm):
    """``reset_parameters`` draws ``dt_bias`` from numpy's default_rng(0)
    as the reference does, so it, ``D`` and ``conv_b`` equal the
    reference's bit for bit, and ``A_log`` within one float32 ulp (torch's
    log rounds log(k) correctly; XLA's is one ulp off at one of 1..32);
    the three stay float32 in a bfloat16 block.  The random weights have
    the reference's shapes and dtypes."""
    jax = jm[0]
    jcfg, tcfg = _both(jm, JAMBA, dtype="bfloat16")
    p = jm[6].mamba_init(jax.random.key(0), jcfg, jcfg.jnp_dtype)
    blk = Mamba(tcfg, device="cpu", dtype=torch.bfloat16)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    for name, a in p.items():
        t = getattr(blk, name)
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), name
    for name in ("dt_bias", "D"):
        assert torch.equal(getattr(blk, name),
                           torch.from_numpy(np.array(p[name]))), name
    np.testing.assert_allclose(blk.A_log.numpy(), np.array(p["A_log"]),
                               rtol=2 ** -23, atol=0)
    assert not bool(blk.conv_b.any())


def test_jamba_forward_matches_the_chunked_reference(jm):
    """Jamba SMOKE with ``ssm_mode = "chunked"`` (ssm_chunk 4): the
    reference's uncached forward runs its chunked scan in every Mamba
    layer; the port's forward, one path for both modes, matches it."""
    jnp, jmod = jm[1], jm[3]
    jcfg, tcfg, params, model = _carried(jm, JAMBA, ssm_mode="chunked",
                                         ssm_chunk=4)
    toks = np.random.default_rng(14).integers(0, jcfg.vocab, (2, 11))
    want, _, _ = jmod.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = model({"tokens": torch.from_numpy(toks)})
    _close(got, want)


@pytest.mark.parametrize("changes", [
    {}, {"capacity_factor": 0.5}, {"n_shared_experts": 1}],
    ids=["smoke", "drops", "shared"])
def test_moe_matches_reference(changes, jm):
    """out and aux at the SMOKE capacity (cf 2: nothing dropped), at cf 0.5
    (C = 4 slots an expert for 28 assignments over 4 experts: 12 dropped,
    so the order of the drops shows) and with one shared expert."""
    jax, jnp, jl = jm[0], jm[1], jm[4]
    jcfg, tcfg = _both(jm, JAMBA, **changes)
    p = jl.moe_init(jax.random.key(13), jcfg, jnp.float32)
    moe = L.MoE(tcfg, device="cpu", dtype=torch.float32)
    moe.load_state_dict(_flat_params(p))
    assert (moe.shared is not None) == bool(tcfg.n_shared_experts)
    x = np.random.default_rng(13).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    want, waux = jl.moe_apply(p, jcfg, jnp.asarray(x))
    got, aux = moe(torch.from_numpy(x))
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, MOE_RTOL * scale)
    _close(aux, waux, MOE_RTOL)
    if "capacity_factor" in changes:
        smoke = L.MoE(configs.get(JAMBA)[1], device="cpu",
                      dtype=torch.float32)
        smoke.load_state_dict(moe.state_dict())
        full, _ = smoke(torch.from_numpy(x))
        assert float((full - got).abs().max()) > 1e-3 * scale


def test_moe_keeps_the_router_float32():
    tcfg = dataclasses.replace(configs.get(GROK)[1], dtype="bfloat16",
                               n_shared_experts=1)
    moe = L.MoE(tcfg, device="cpu", dtype=torch.bfloat16)
    moe.reset_parameters(torch.Generator().manual_seed(0))
    assert moe.router.dtype == torch.float32
    assert {moe.w_gate.dtype, moe.w_down.dtype, moe.shared.w_up.dtype} == \
        {torch.bfloat16}
    out, aux = moe(torch.randn(2, 3, tcfg.d_model).bfloat16())
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", [JAMBA, GROK, "llama3.2-3b"])
def test_forward_aux_matches_reference(arch, jm):
    """``forward(return_aux=True)`` sums the MoE layers' aux losses as the
    reference's forward does (0 without MoE); the two-item return stays."""
    jnp, jmod = jm[1], jm[3]
    jcfg, tcfg, params, model = _carried(jm, arch, seed=2)
    toks = np.random.default_rng(14).integers(0, jcfg.vocab, (2, 6))
    want, _, waux = jmod.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, cache, aux = model({"tokens": torch.from_numpy(toks)},
                            return_aux=True)
    assert cache is None and aux.dtype == torch.float32 and aux.dim() == 0
    _close(got, want)
    _close(aux, waux, 1e-5)
    assert len(model({"tokens": torch.from_numpy(toks)})) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_hybrid_leaf_for_leaf(dtype, jm):
    """Jamba's 8-layer period carried leaf for leaf, Mamba and MoE leaves
    included; ``dt_bias``, ``A_log``, ``D`` and the router stay float32 in
    a bfloat16 model, bit-equal to the reference's."""
    jax = jm[0]
    jcfg, tcfg = _both(jm, JAMBA, dtype=dtype)
    assert (tcfg.period_len, tcfg.n_periods) == (8, 1)
    tree = _tree(jax, jm[3].init_params(jcfg, jax.random.key(5)))
    model = model_params_from_arrays(tcfg, tree, device="cpu")
    state = model.state_dict()
    f32 = {"mixer.dt_bias", "mixer.A_log", "mixer.D", "ffn.router"}
    n = 0
    for li, blk in enumerate(tree["period"]):
        for name, a in _leaves(blk).items():
            t = state[f"blocks.{li}.{name}"]
            want_dtype = (torch.float32 if name in f32
                          else getattr(torch, dtype))
            assert t.dtype == want_dtype, name
            assert np.array_equal(_bits(t), _bits(a[0])), name
            n += 1
    assert n == len(state) - 3
    assert np.array_equal(_bits(state["embed"]), _bits(tree["embed"]))
    mixers = [tcfg.layer_spec(i) for i in range(8)]
    assert [type(b.mixer).__name__ for b in model.blocks] == \
        ["GQA" if m == "attn" else "Mamba" for m, _ in mixers]
    assert [type(b.ffn).__name__ for b in model.blocks] == \
        ["MoE" if f == "moe" else "SwiGLU" for _, f in mixers]


def test_hybrid_cache_layout():
    """A KV cache for jamba's attention layer (4), the Mamba state
    ({'h' float32, 'conv' in the model's dtype}) for the other seven."""
    cfg = dataclasses.replace(configs.get(JAMBA)[1], dtype="bfloat16")
    model = Model(cfg, device="cpu")
    cache = model.init_cache(3, 10)
    Di = cfg.ssm_expand * cfg.d_model
    for i, c in enumerate(cache):
        if i == 4:
            assert set(c) == {"k", "v"}
            assert c["k"].shape == (3, 10, cfg.n_kv_heads, cfg.head_dim)
        else:
            assert set(c) == {"h", "conv"}
            assert c["h"].shape == (3, Di, cfg.ssm_state_dim)
            assert c["h"].dtype == torch.float32
            assert c["conv"].shape == (3, cfg.ssm_conv_dim - 1, Di)
            assert c["conv"].dtype == torch.bfloat16


def test_hybrid_serve_gives_the_reference_tokens(jm):
    """The port's serve loop on jamba SMOKE (carried parameters and the
    JAX serve's prompts) gives the tokens ``repro.launch.serve.main``
    generated."""
    jax, jserve = jm[0], jm[5]
    argv = ["--arch", JAMBA, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "6", "--seed", "4"]
    want = np.asarray(jserve.main(argv))
    jcfg, tcfg, _, model = _carried(jm, JAMBA, seed=4)
    prompts = np.array(jax.random.randint(jax.random.key(1), (2, 6), 0,
                                            jcfg.vocab))
    res = serve.generate(model, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


@pytest.mark.parametrize("arch", [JAMBA, GROK])
def test_serve_main_runs_moe_and_hybrid_on_the_cpu(arch):
    tokens = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert tokens.shape == (2, 3) and tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512


def test_hybrid_cached_multi_token_forward_raises():
    model = init_params(configs.get(JAMBA)[1], device="cpu")
    cache = model.init_cache(1, 8)
    with pytest.raises(ValueError, match="one token a step"):
        model({"tokens": torch.zeros((1, 3), dtype=torch.int64)},
              cache=cache, cache_index=0)
