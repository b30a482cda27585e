"""The model blocks of deepseek-v2-lite-16b (MLA), rwkv6-7b (RWKV-6's time
mix and channel mix) and hubert-xlarge (LayerNorm, the GELU MLP, a
non-causal encoder) against the JAX package's.

The same inputs, made with numpy, go through both; parameters are the
reference's, copied leaf for leaf (``repro_torch.carry.
model_params_from_arrays`` for whole models).  Tolerances as in
``tests/test_torch_models.py``: float32 on both sides, logits and block
outputs within 1e-4 (sums run in another order on each side); the
recurrent state S of RWKV-6 within 1e-5; greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import model_params_from_arrays
from repro_torch.launch import serve
from repro_torch.models import Model, init_params, layers as L
from repro_torch.models.ssm import RWKV6, RWKVChannelMix
from repro_torch.runtime import build_prefill_step, build_serve_step

ATOL = 1e-4
STATE_ATOL = 1e-5
MLA_ARCH, RWKV_ARCH, HUBERT = ("deepseek-v2-lite-16b", "rwkv6-7b",
                               "hubert-xlarge")


@pytest.fixture(scope="module")
def jm():
    """The JAX package's model stack, imported here: the machine with the
    card has no JAX."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.launch import serve as jserve
    from repro.models import layers as jlayers
    from repro.models import ssm as jssm
    return dict(jax=jax, jnp=jax.numpy, configs=jconfigs, models=jmodels,
                layers=jlayers, serve=jserve, ssm=jssm)


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _cfgs(jm, arch):
    return jm["configs"].get(arch)[1], configs.get(arch)[1]


def _load(module, params):
    """Copy the reference's leaves (a flat dict of arrays) into
    ``module``'s parameters of the same names, dtype for dtype."""
    state = module.state_dict()
    assert set(state) == set(params)
    for name, a in params.items():
        t = torch.from_numpy(np.array(a))
        assert t.shape == state[name].shape and t.dtype == state[name].dtype
        state[name].copy_(t)
    return module


def _rng_params(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
            for n, s in shapes.items()}


# -- the blocks, one at a time ------------------------------------------------

def test_layer_norm_module_matches_reference(jm):
    jnp, jl = jm["jnp"], jm["layers"]
    p = _rng_params({"w": (48,), "b": (48,)}, 0)
    ln = _load(L.LayerNorm(48, 1e-5, device="cpu", dtype=torch.float32), p)
    x = np.random.default_rng(1).standard_normal((2, 5, 48)).astype(
        np.float32) * 3
    _close(ln(torch.from_numpy(x)),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(p["w"]),
                         jnp.asarray(p["b"]), 1e-5))
    ln.reset_parameters()
    assert torch.equal(ln.w, torch.ones(48)) and torch.equal(ln.b,
                                                             torch.zeros(48))


def test_gelu_mlp_matches_reference(jm):
    """Biases drawn nonzero; ``jax.nn.gelu``'s tanh approximation."""
    jnp, jl = jm["jnp"], jm["layers"]
    p = _rng_params({"w_in": (24, 40), "b_in": (40,), "w_out": (40, 24),
                     "b_out": (24,)}, 2)
    mlp = _load(L.GELUMLP(24, 40, device="cpu", dtype=torch.float32), p)
    x = np.random.default_rng(3).standard_normal((2, 3, 24)).astype(
        np.float32) * 2
    want = jl.gelu_mlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x))
    _close(mlp(torch.from_numpy(x)), want, atol=1e-5)


def _mla(jm, seed):
    jax = jm["jax"]
    jcfg, tcfg = _cfgs(jm, MLA_ARCH)
    p = jm["layers"].mla_init(jax.random.key(seed), jcfg, jcfg.jnp_dtype)
    blk = _load(L.MLA(tcfg, device="cpu", dtype=torch.float32), p)
    return jcfg, tcfg, p, blk


def test_mla_block_matches_reference(jm):
    """Without a cache (causal over T = 6), and a decode token at
    cache_index 5 of a 13-position compressed cache whose first 5
    positions hold earlier entries; the cache is updated in place."""
    jnp = jm["jnp"]
    jcfg, tcfg, p, blk = _mla(jm, 5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    want, _ = jm["layers"].mla_apply(p, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos))
    got, cache = blk(torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None and got.shape == (2, 6, tcfg.d_model)
    _close(got, want)

    ckv = rng.standard_normal((2, 13, tcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 13, 1, tcfg.qk_rope_head_dim)).astype(
        np.float32)
    ckv[:, 5:] = kr[:, 5:] = 0.0
    x1, pos1 = x[:, :1], np.full((2, 1), 5)
    want, jc = jm["layers"].mla_apply(
        p, jcfg, jnp.asarray(x1), jnp.asarray(pos1),
        cache={"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)},
        cache_index=5)
    tc = {"ckv": torch.from_numpy(ckv.copy()),
          "krope": torch.from_numpy(kr.copy())}
    got, tc2 = blk(torch.from_numpy(x1), torch.from_numpy(pos1), tc, 5)
    assert tc2 is tc
    _close(got, want)
    _close(tc["ckv"], jc["ckv"], atol=1e-5)
    _close(tc["krope"], jc["krope"], atol=1e-5)
    with pytest.raises(ValueError, match="overruns"):
        blk(torch.from_numpy(x1), torch.from_numpy(pos1), tc, 13)


def _rwkv(jm, seed):
    jax = jm["jax"]
    jcfg, tcfg = _cfgs(jm, RWKV_ARCH)
    p = jm["ssm"].rwkv6_init(jax.random.key(seed), jcfg, jcfg.jnp_dtype)
    blk = _load(RWKV6(tcfg, device="cpu", dtype=torch.float32), p)
    assert blk.decay_base.dtype == blk.bonus_u.dtype == torch.float32
    return jcfg, tcfg, p, blk


@pytest.mark.parametrize("T", [1, 7, 64, 128])
def test_rwkv6_time_mix_matches_reference(T, jm):
    """Without a state, and from a random state (S, shift): the output
    and the new state, at T 1 and 7 (one scan), 64 (one chunk) and 128
    (two checkpointed chunks of the reference's scan)."""
    jnp = jm["jnp"]
    jcfg, tcfg, p, blk = _rwkv(jm, 6 + T)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    want, _ = jm["ssm"].rwkv6_apply(p, jcfg, jnp.asarray(x))
    got, st = blk(torch.from_numpy(x))
    assert st is None
    _close(got, want)
    H, hd = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    S0 = rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    sh = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
    want, js = jm["ssm"].rwkv6_apply(
        p, jcfg, jnp.asarray(x), state={"S": jnp.asarray(S0),
                                        "shift": jnp.asarray(sh)})
    got, st = blk(torch.from_numpy(x), {"S": torch.from_numpy(S0),
                                        "shift": torch.from_numpy(sh)})
    _close(got, want)
    _close(st["S"], js["S"], atol=STATE_ATOL)
    _close(st["shift"], js["shift"], atol=0.0)


def test_rwkv_channel_mix_matches_reference(jm):
    jax, jnp = jm["jax"], jm["jnp"]
    jcfg, tcfg = _cfgs(jm, RWKV_ARCH)
    p = jm["ssm"].rwkv_channel_mix_init(jax.random.key(9), jcfg,
                                        jcfg.jnp_dtype)
    p = dict(p, mu=np.random.default_rng(9).uniform(
        0, 1, tcfg.d_model).astype(np.float32))
    cm = _load(RWKVChannelMix(tcfg, device="cpu", dtype=torch.float32), p)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    sh = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    for shift in (None, sh):
        want, wlast = jm["ssm"].rwkv_channel_mix_apply(
            jp, jcfg, jnp.asarray(x),
            shift=None if shift is None else jnp.asarray(shift))
        got, last = cm(torch.from_numpy(x),
                       None if shift is None else torch.from_numpy(shift))
        _close(got, want)
        _close(last, wlast, atol=0.0)


# -- whole models -------------------------------------------------------------

def _carried(jm, arch, seed=0, **changes):
    jax = jm["jax"]
    jcfg, tcfg = _cfgs(jm, arch)
    jcfg = dataclasses.replace(jcfg, **changes)
    tcfg = dataclasses.replace(tcfg, **changes)
    params = jm["models"].init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, model_params_from_arrays(tcfg, tree,
                                                        device="cpu")


@pytest.mark.parametrize("arch", [MLA_ARCH, RWKV_ARCH])
def test_smoke_forward_and_decode_loop_match_reference(arch, jm):
    """The uncached forward over 6 tokens, then a 6-token decode loop
    through the serve step against the reference's ``decode_step`` (an
    8-position cache): logits at every step, and the last step equal to
    the uncached forward's last position."""
    jnp, jmod = jm["jnp"], jm["models"]
    jcfg, tcfg, params, model = _carried(jm, arch)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 6))
    want, _, _ = jmod.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = model({"tokens": torch.from_numpy(toks)})
    _close(got, want)
    step = build_serve_step(tcfg)
    jcache, tcache = jmod.init_cache(jcfg, 2, 8), model.init_cache(2, 8)
    for t in range(6):
        tok = toks[:, t:t + 1]
        want1, jcache = jmod.decode_step(params, jcfg,
                                         {"tokens": jnp.asarray(tok)},
                                         jcache, t)
        got1, tcache = step(model, {"tokens": torch.from_numpy(tok)},
                            tcache, t)
        _close(got1, want1)
    _close(got1, got[:, -1])


@pytest.mark.parametrize("arch", [MLA_ARCH, RWKV_ARCH])
def test_serve_gives_the_reference_tokens(arch, jm):
    """The port's serve loop (carried parameters, the JAX serve's prompts)
    gives the tokens ``repro.launch.serve.main`` generated."""
    jax = jm["jax"]
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "6", "--seed", "4"]
    want = np.asarray(jm["serve"].main(argv))
    jcfg, _, _, model = _carried(jm, arch, seed=4)
    prompts = np.array(jax.random.randint(jax.random.key(1), (2, 6), 0,
                                            jcfg.vocab))
    res = serve.generate(model, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_hubert_prefill_matches_reference(jm):
    """hubert SMOKE: the prefill step over frame embeddings, the full
    non-causal forward, against the reference's."""
    jnp, jmod = jm["jnp"], jm["models"]
    jcfg, tcfg, params, model = _carried(jm, HUBERT)
    assert isinstance(model.final_norm, L.LayerNorm)
    assert isinstance(model.blocks[0].ffn, L.GELUMLP)
    emb = np.random.default_rng(12).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    want, _, _ = jmod.forward(params, jcfg, {"embeds": jnp.asarray(emb)})
    got = build_prefill_step(tcfg)(model, {"embeds": torch.from_numpy(emb)})
    assert got.shape == (2, 9, jcfg.vocab)
    _close(got, want)
    # non-causal: the first frame's logits see the last frame
    emb2 = emb.copy()
    emb2[:, -1] += 1.0
    got2 = build_prefill_step(tcfg)(model, {"embeds": torch.from_numpy(emb2)})
    assert not torch.allclose(got[:, 0], got2[:, 0])


@pytest.mark.parametrize("arch", [MLA_ARCH, RWKV_ARCH])
def test_serve_main_runs_the_new_families_on_the_cpu(arch):
    tokens = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert tokens.shape == (2, 3) and tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512


def test_hubert_keeps_no_serve_path():
    with pytest.raises(SystemExit, match="no autoregressive"):
        serve.main(["--arch", HUBERT, "--smoke", "--device", "cpu"])


def test_rwkv_cache_layout():
    cfg = configs.get(RWKV_ARCH)[1]
    model = init_params(cfg, device="cpu")
    cache = model.init_cache(3, 8)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    for c in cache:
        assert set(c) == {"S", "shift", "cm_shift"}
        assert c["S"].shape == (3, H, hd, hd) and c["S"].dtype == torch.float32
        assert c["shift"].shape == c["cm_shift"].shape == (3, cfg.d_model)
    mla = init_params(configs.get(MLA_ARCH)[1], device="cpu",
                      dtype=torch.bfloat16).init_cache(2, 5)
    mcfg = configs.get(MLA_ARCH)[1]
    assert mla[0]["ckv"].shape == (2, 5, mcfg.kv_lora_rank)
    assert mla[0]["krope"].shape == (2, 5, 1, mcfg.qk_rope_head_dim)
    assert mla[0]["ckv"].dtype == torch.bfloat16


def test_rwkv_carry_keeps_decay_and_bonus_float32(jm):
    jcfg, tcfg, params, model = _carried(jm, RWKV_ARCH, dtype="bfloat16")
    st = model.state_dict()
    for name, t in st.items():
        want = (torch.float32 if name.endswith(("decay_base", "bonus_u"))
                else torch.bfloat16)
        assert t.dtype == want, name
    tree = jm["jax"].tree.map(np.asarray, params)
    assert tree["period"][0]["mixer"]["bonus_u"].dtype == np.float32
