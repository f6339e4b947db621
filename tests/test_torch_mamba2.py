"""The port's Mamba2 language model against the reference's, on the CPU.

Configs: ``mamba2-370m``'s SMOKE and the 3-layer ``SSMConfig`` of
``tests/test_models.py``. Weights come from the reference's own
initializer, with every zero-initialized vector (dt bias, A_log, D, the
norms, the conv bias) replaced by seeded numpy draws so that each is
exercised, and are carried across by ``params_from_numpy``; tokens come
from numpy. Both sides run on the CPU: the port's SSD wrapper takes its
plain (sequential) version there, the reference's block its chunked scan.

Tolerances, fp32: 1e-4 of the output scale for the block, the logits,
the loss, the decode logits and caches — the two compute the same sums
in another order (sequential against chunked scan, other matmul
orders), an error near 1e-6 of the scale; greedy ``generate`` must give
the same tokens. The port's own decode against its own forward: 5e-4,
as ``tests/test_models.py`` holds the reference.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_370m as jmamba_cfg
from repro.configs.base import SSMConfig as JSSMConfig
from repro.core.sharding import ShardingPolicy
from repro.models import mamba2 as jmamba2
from repro.models import ssm_lm as jssm_lm
from repro.serve import lm as jlm
from repro_torch.api import RunConfig, RunConfigError
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SSMConfig
from repro_torch.core.sharding import ShardingPolicy as PortPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mamba2, ssm_lm
from repro_torch.serve import lm

THREE = SSMConfig(name="ssm", family="ssm", num_layers=3, d_model=64,
                  ssm_state=16, vocab_size=97, head_dim=16, chunk_size=8)
CFGS = {"mamba2-370m-smoke": get_smoke_config("mamba2-370m"), "ssm3": THREE}
REL = 1e-4


def _jcfg(cfg):
    return JSSMConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The reference's initial parameters as numpy, with the zero and
    constant vectors replaced by seeded draws."""
    cfg = CFGS[name]
    p = jax.tree.map(np.asarray,
                     jssm_lm.init_params(jax.random.PRNGKey(0), _jcfg(cfg)))
    r = np.random.RandomState(1)
    blk = dict(p["blocks"])
    for k, scale, off in (("dt_bias", 0.5, 0.0), ("A_log", 0.5, 0.0),
                          ("D", 0.1, 1.0), ("norm_scale", 0.1, 0.0),
                          ("conv_b", 0.1, 0.0)):
        blk[k] = (off + scale * r.randn(*blk[k].shape)).astype(np.float32)
    out = dict(p, blocks=blk)
    for k in ("block_norms", "final_norm"):
        out[k] = (0.1 * r.randn(*p[k].shape)).astype(np.float32)
    return out


def _params(name):
    return ssm_lm.params_from_numpy(_weights(name), CFGS[name], device="cpu")


def _jparams(name):
    return jax.tree.map(jnp.asarray, _weights(name))


def _tokens(cfg, shape, seed=2):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jfns(name):
    jcfg = _jcfg(CFGS[name])
    return {
        "forward": jax.jit(lambda p, t: jssm_lm.forward(p, t, jcfg)),
        "loss": jax.jit(lambda p, b: jssm_lm.lm_loss(p, b, jcfg)),
        "decode": jax.jit(lambda p, c, t: jssm_lm.decode_step(p, c, t, jcfg)),
    }


def test_configs_are_the_references():
    for name in ("mamba2-370m",):
        for port, ref in ((get_config(name), jmamba_cfg.CONFIG),
                          (get_smoke_config(name), jmamba_cfg.SMOKE)):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.param_count() == ref.param_count()
            assert (port.d_inner, port.num_ssm_heads) == (
                ref.d_inner, ref.num_ssm_heads)
    cfg = get_config("mamba2-370m")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state,
            cfg.head_dim, cfg.num_ssm_heads, cfg.chunk_size) == (
        48, 1024, 50280, 128, 64, 32, 256)


@pytest.mark.parametrize("name", CFGS)
def test_block_forward_matches_the_reference(name):
    cfg = CFGS[name]
    h = np.random.RandomState(3).randn(2, 16, cfg.d_model).astype(np.float32)
    kw = dict(num_heads=cfg.num_ssm_heads, head_dim=cfg.head_dim,
              ssm_state=cfg.ssm_state, chunk=cfg.chunk_size)
    jblock = jax.jit(functools.partial(jmamba2.block_forward, **kw))
    for i in range(cfg.num_layers):
        bp = {k: v[i] for k, v in _params(name)["blocks"].items()}
        jbp = {k: v[i] for k, v in _jparams(name)["blocks"].items()}
        got = mamba2.block_forward(bp, torch.from_numpy(h), **kw)
        want = jblock(jbp, jnp.asarray(h))
        assert got.shape == want.shape
        assert _rel(got, want) <= REL, (i, _rel(got, want))


@pytest.mark.parametrize("name", CFGS)
def test_forward_and_loss_match_the_reference(name):
    cfg = CFGS[name]
    toks = _tokens(cfg, (2, 16))
    labels = _tokens(cfg, (2, 16), seed=3)
    p, jp = _params(name), _jparams(name)
    logits = ssm_lm.forward(p, torch.from_numpy(toks), cfg)
    want = _jfns(name)["forward"](jp, jnp.asarray(toks))
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert _rel(logits, want) <= REL
    loss = ssm_lm.lm_loss(p, {"tokens": toks, "labels": labels}, cfg)
    jloss = _jfns(name)["loss"](jp, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    assert loss.shape == () and np.isfinite(loss.item())
    assert abs(loss.item() - float(jloss)) <= REL * max(1.0, abs(float(jloss)))


@pytest.mark.parametrize("name", CFGS)
def test_decode_step_matches_the_reference(name):
    cfg = CFGS[name]
    toks = _tokens(cfg, (2, 4), seed=4)
    p, jp = _params(name), _jparams(name)
    cache = ssm_lm.init_cache(cfg, 2, 8, device="cpu")
    jcache = jssm_lm.init_cache(_jcfg(cfg), 2, 8)
    for t in range(toks.shape[1]):
        lg, cache = ssm_lm.decode_step(p, cache, torch.from_numpy(
            toks[:, t:t + 1]), cfg)
        jlg, jcache = _jfns(name)["decode"](jp, jcache,
                                            jnp.asarray(toks[:, t:t + 1]))
        assert _rel(lg, jlg) <= REL, t
        for k in ("conv", "ssm"):
            assert cache[k].shape == jcache[k].shape
            assert _rel(cache[k], jcache[k]) <= REL, (t, k)
        assert cache["pos"] == int(jcache["pos"]) == t + 1


@pytest.mark.parametrize("name", CFGS)
def test_greedy_generate_gives_the_references_tokens(name):
    cfg = CFGS[name]
    prompts = _tokens(cfg, (2, 6), seed=5)
    got = lm.generate(_params(name), torch.from_numpy(prompts), cfg, 5)
    want = jlm.generate(_jparams(name), jnp.asarray(prompts), _jcfg(cfg), 5)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", CFGS)
def test_decode_matches_forward_in_the_port(name):
    """Teacher-forced decode against the forward's logits (5e-4, as
    ``tests/test_models.py``), and prefill's last logits against the
    forward's last position."""
    cfg = CFGS[name]
    p = _params(name)
    toks = torch.from_numpy(_tokens(cfg, (2, 8), seed=6))
    logits = ssm_lm.forward(p, toks, cfg)
    cache = ssm_lm.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        lg, cache = ssm_lm.decode_step(p, cache, toks[:, t:t + 1], cfg)
        np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                   rtol=5e-4, atol=5e-4)
    prefill, _ = lm.make_serve_fns(cfg)
    last, cache = prefill(p, toks, 8)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(),
                               rtol=5e-4, atol=5e-4)
    assert cache["pos"] == 8


def test_sampling_draws_from_an_explicit_generator():
    cfg = CFGS["ssm3"]
    p, prompts = _params("ssm3"), _tokens(cfg, (2, 3))
    with pytest.raises(ValueError, match="Generator"):
        lm.generate(p, prompts, cfg, 2, temperature=1.0)
    draws = [lm.generate(p, prompts, cfg, 4, temperature=1.0,
                         generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size


def test_params_from_numpy_checks_names_and_shapes():
    tree = _weights("ssm3")
    p = _params("ssm3")
    assert "unembed" not in p  # tied to embed
    assert p["blocks"]["in_proj"].shape == (3, 64, 2 * 128 + 2 * 16 + 8)
    bad = dict(tree, blocks=dict(tree["blocks"]))
    bad["blocks"]["conv_w"] = bad["blocks"]["conv_w"][:, :2]
    with pytest.raises(ValueError, match="conv_w"):
        ssm_lm.params_from_numpy(bad, THREE, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        ssm_lm.params_from_numpy(missing, THREE, device="cpu")
    untied = dataclasses.replace(THREE, tie_embeddings=False)
    with pytest.raises(ValueError, match="unembed"):
        ssm_lm.params_from_numpy(tree, untied, device="cpu")
    bf = ssm_lm.params_from_numpy(tree, THREE, device="cpu",
                                  dtype=torch.bfloat16)
    assert bf["blocks"]["A_log"].dtype == torch.bfloat16


def test_init_params_follows_the_references_law():
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(THREE, tie_embeddings=False)
    p = ssm_lm.init_params(cfg, gen, device="cpu")
    shapes = ssm_lm.param_shapes(cfg)
    assert set(p) == set(shapes) and set(p["blocks"]) == set(
        shapes["blocks"])
    for k, v in p["blocks"].items():
        assert tuple(v.shape) == shapes["blocks"][k], k
    assert torch.equal(p["blocks"]["D"], torch.ones(3, 8))
    assert torch.equal(p["blocks"]["A_log"], torch.zeros(3, 8))
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["blocks"]["in_proj"].std().item() - 64 ** -0.5) < 0.01
    again = ssm_lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    logits = ssm_lm.forward(p, _tokens(cfg, (1, 8)), cfg)
    assert bool(torch.isfinite(logits).all())


def test_later_slices_raise():
    """A policy whose mesh is None (the reference's ``NO_POLICY``) is no
    policy: the forward and ``generate`` are the unsharded ones, bit for
    bit. A process mesh (one process a shard) raises naming the next
    slice, and a policy over a mesh outside ``spmd.run`` raises (the
    entry points are per-shard functions there). A language model is not
    a ``RunConfig`` model (it is scored and decoded through ``ssm_lm`` /
    ``serve.lm``)."""
    p, toks = _params("ssm3"), _tokens(THREE, (1, 8))
    want = ssm_lm.forward(p, toks, THREE)
    for policy in (ShardingPolicy(mesh=None, plan="cp"),
                   PortPolicy(mesh=None, plan="cp")):
        assert torch.equal(ssm_lm.forward(p, toks, THREE, policy), want)
        assert torch.equal(lm.generate(p, toks, THREE, 2, policy=policy),
                           lm.generate(p, toks, THREE, 2))
    procs = object.__new__(mesh_lib.ProcessMesh)
    with pytest.raises(NotImplementedError, match="next slice"):
        ssm_lm.forward(p, toks, THREE, PortPolicy(mesh=procs))
    with pytest.raises(NotImplementedError, match="next slice"):
        lm.generate(p, toks, THREE, 2, mesh=procs)
    mesh = mesh_lib.Mesh((("data", 1), ("model", 2)), ["cpu"] * 2)
    with pytest.raises(RuntimeError, match="spmd.run"):
        ssm_lm.forward(p, toks, THREE, PortPolicy(mesh=mesh, plan="cp"))
    with pytest.raises(RunConfigError) as e:
        RunConfig(model="mamba2-370m", mode="infer").validate()
    assert e.value.field == "model" and "generate" in e.value.fix


def test_entry_points_default_to_the_card():
    """With no device, parameters and caches go to the card; without a
    card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places on it")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm_lm.init_params(THREE, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm_lm.params_from_numpy(_weights("ssm3"), THREE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm_lm.init_cache(THREE, 1, 8)
