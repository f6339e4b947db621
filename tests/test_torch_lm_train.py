"""Language-model training in the port against the reference's, on the
CPU: the loss and every gradient leaf of each family, the SSD scan's
autograd ``Function`` and the Mamba2 conv's gradient, layer remat,
``make_lm_train_step``, the token corpus, the LM launcher and the
``serve_lm`` example.

Configs: every LM arch's SMOKE, the reference's ``tests/test_models.py``
transformer CASES (dense, qwen-like, gemma-like alternating local/global
with softcaps, MoE, arctic-like, encoder) with its vlm-like case, and a
hybrid whose layers do not divide into whole groups. Weights come from
the reference's own ``init_params``, every zero-initialized vector
replaced by seeded numpy draws, and carry across by
``params_from_numpy``; inputs come from numpy. A config's reference
(``jax.value_and_grad(lm_loss)``, and the reference's own
``make_lm_train_step`` under ``jax.jit``) is computed in this process
when a test first asks for it (``functools.cache``, XLA level 0).

Tolerances, fp32:
* loss and each gradient leaf: 1e-4 of the reference leaf's max-abs
  (the two compute the same sums in other orders, and the port's CPU
  scan is sequential where the reference's is chunked: errors near 1e-6
  of the scale);
* losses over 3 Adam steps: 1e-4 relative;
* parameters after them: each element within 1e-4 of the leaf's scale,
  or else moved by less than twice the learning rates summed over the
  steps, and such elements at most 1% of a leaf. Adam's update is
  about ``lr * sign(g)`` wherever |g| >> eps, so a gradient element
  near zero, whose sign rests on summation order, takes a whole ``lr``
  step either way (ROADMAP §3, fault 3);
* remat on against off in the port: bitwise (the recompute runs the
  same operations on the same inputs).
"""
import argparse
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.sharding import NO_POLICY
from repro.data.synthetic import make_token_dataset as jmake_token_dataset
from repro.models import mamba2 as jmamba2
from repro.models import ssm_lm as jssm_lm
from repro.models import transformer as jtransformer
from repro.optim.adam import Adam as JAdam
from repro.optim.adam import warmup_cosine as jwarmup_cosine
from repro.train.train_step import make_lm_train_step as jmake_lm_train_step
from repro_torch import configs
from repro_torch.configs.base import (HybridConfig, SSMConfig,
                                      TransformerConfig)
from repro_torch.core import flags
from repro_torch.core import seq_parallel
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.core.sharding import ShardingPolicy, shard_tree
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.examples import serve_lm
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, ProcessMesh
from repro_torch.models import lm_module, mamba2, ssm_lm, transformer
from repro_torch.optim.adam import Adam, warmup_cosine
from repro_torch.train.train_step import (lm_value_and_grad,
                                          make_lm_train_step)

REL = 1e-4
B, S = 2, 16
STEPS = 3
LR = (3e-3, 10)  # the launcher's warmup_cosine(peak, warmup, STEPS)


def _mk(name, **kw):
    base = dict(name=name, family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97)
    base.update(kw)
    return TransformerConfig(**base)


CFGS = {f"smoke-{a}": configs.get_smoke_config(a) for a in configs.LM_ARCHS}
CFGS.update({c.name: c for c in (
    _mk("dense"),
    _mk("qwen-like", qkv_bias=True, num_kv_heads=4, tie_embeddings=True),
    _mk("gemma-like", alt_local_global=True, sliding_window=16,
        logit_softcap=30.0, attn_softcap=50.0),
    _mk("moe-like", family="moe", num_experts=4, top_k=2),
    _mk("arctic-like", family="moe", num_experts=4, top_k=2,
        moe_dense_residual=True, dense_residual_d_ff=64),
    _mk("encoder-like", family="audio", causal=False, gated_mlp=False,
        activation="gelu", embed_inputs=False, supports_decode=False),
    _mk("vlm-like", family="vlm"),
)})
# 5 layers in groups of 2 (one left over), attention heads 8 wide
CFGS["hybrid-odd"] = HybridConfig(
    name="hybrid-odd", family="hybrid", num_layers=5, d_model=64,
    ssm_state=16, vocab_size=97, num_heads=8, num_kv_heads=2, d_ff=128,
    attn_every=2, head_dim=16, chunk_size=8)
# 3 Adam steps against the reference's own step: a config of each kind
STEP_CFGS = ["smoke-mamba2-370m", "smoke-zamba2-1.2b", "smoke-qwen1.5-0.5b",
             "smoke-phi3.5-moe", "gemma-like", "encoder-like"]
# remat against none in the port: a dense stack, the gemma-like pairs,
# Mamba2 and a hybrid
REMAT_CFGS = ["dense", "gemma-like", "smoke-mamba2-370m", "hybrid-odd"]
DRAWS = {"ln1": (0.1, 0.0), "ln2": (0.1, 0.0), "bq": (0.1, 0.0),
         "bk": (0.1, 0.0), "bv": (0.1, 0.0), "final_norm": (0.1, 0.0),
         "block_norms": (0.1, 0.0), "dt_bias": (0.5, 0.0),
         "A_log": (0.5, 0.0), "D": (0.1, 1.0), "norm_scale": (0.1, 0.0),
         "conv_b": (0.1, 0.0)}


def _jcfg(cfg):
    cls = {TransformerConfig: jbase.TransformerConfig,
           HybridConfig: jbase.HybridConfig,
           SSMConfig: jbase.SSMConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def _jmod(cfg):
    return jtransformer if isinstance(cfg, TransformerConfig) else jssm_lm


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _draws(cfg):
    """Seeded numpy values for the zero-initialized leaves, by path."""
    r = np.random.RandomState(1)
    out = {}

    def walk(shapes, path):
        for name in sorted(shapes):
            if isinstance(shapes[name], dict):
                walk(shapes[name], path + (name,))
            elif name in DRAWS:
                scale, off = DRAWS[name]
                out[path + (name,)] = (off + scale * r.randn(
                    *shapes[name])).astype(np.float32)
    walk(lm_module(cfg).param_shapes(cfg), ())
    return out


def _replace(tree, draws):
    tree = dict(tree)
    for path, value in draws.items():
        node = tree
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = value
    return tree


def _inputs(cfg, seed=2):
    """A numpy batch: tokens (or hubert's frames), labels (two masked
    positions a row for the transformers), the VLM's image prefix."""
    r = np.random.RandomState(seed)
    if getattr(cfg, "embed_inputs", True):
        x = r.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    else:
        x = (0.1 * r.randn(B, S, cfg.d_model)).astype(np.float32)
    labels = r.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if isinstance(cfg, TransformerConfig):
        labels[:, :2] = -1
    batch = {"tokens": x, "labels": labels}
    if getattr(cfg, "family", "") == "vlm":
        batch["image_embeds"] = (0.02 * r.randn(B, 4, cfg.d_model)
                                 ).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def reference(cid):
    """(the parameter tree, the loss and the gradient tree of
    ``jax.value_and_grad(lm_loss)``), as numpy: one jitted program."""
    cfg = CFGS[cid]
    jcfg, jm = _jcfg(cfg), _jmod(cfg)
    draws = {p: jnp.asarray(v) for p, v in _draws(cfg).items()}

    def program(key, batch):
        p = _replace(jm.init_params(key, jcfg), draws)
        loss, g = jax.value_and_grad(jm.lm_loss)(p, batch, jcfg)
        return p, loss, g

    out = _jit(program)(jax.random.PRNGKey(0), _jbatch(_inputs(cfg)))
    return jax.tree.map(np.asarray, out)


@functools.cache
def reference_step(cid):
    """The reference's own ``make_lm_train_step`` (no mesh, no jit of its
    own) under ``jax.jit``, with the launcher's Adam over STEPS steps;
    and that optimizer."""
    cfg = CFGS[cid]
    opt = JAdam(lr=jwarmup_cosine(*LR, STEPS), grad_clip=1.0)
    step = jmake_lm_train_step(_jmod(cfg).lm_loss, _jcfg(cfg), None,
                               NO_POLICY, opt, batch_specs={},
                               param_specs=None, jit=False)
    return _jit(step), opt


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small
    (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(cid, tree=None):
    cfg = CFGS[cid]
    return lm_module(cfg).params_from_numpy(
        reference(cid)[0] if tree is None else tree, cfg, device="cpu")


def _leaf_errors(got, want):
    """{path: max abs diff / the reference leaf's max-abs} over the
    port's tree ``got`` and the reference's numpy tree ``want``."""
    out = {}
    for (path, g), (wpath, w) in zip(tree_lib.key_paths(got),
                                     tree_lib.key_paths(want)):
        assert path == wpath
        w = np.asarray(w, dtype=np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        out[path] = np.abs(g.detach().double().numpy() - w).max() / scale
    return out


def _grads(cid, params, batch):
    cfg = CFGS[cid]
    return lm_value_and_grad(lm_module(cfg).lm_loss, params, batch, cfg)


# ----------------------------------------------------- gradients ----
@pytest.mark.parametrize("cid", list(CFGS))
def test_loss_and_every_gradient_match_the_reference(cid):
    """``jax.value_and_grad(lm_loss)`` on the same weights and inputs:
    the loss and every leaf within REL of its scale (the MoE dispatch,
    the SSD scan's Function and the conv's add included); every leaf
    gets a gradient, and the parameters record no graph."""
    _, jloss, jgrads = reference(cid)
    params = _params(cid)
    loss, grads = _grads(cid, params, _tbatch(_inputs(CFGS[cid])))
    assert abs(loss.item() - float(jloss)) <= REL * max(1.0, abs(jloss))
    errs = _leaf_errors(grads, jgrads)
    assert max(errs.values()) <= REL, {k: v for k, v in errs.items()
                                       if v > REL}
    assert all(np.abs(np.asarray(g)).max() > 0
               for g in tree_lib.leaves(jgrads))
    assert not any(t.requires_grad for t in tree_lib.leaves(params))


def test_the_scan_gradient_flows_through_the_function():
    """A Mamba2 step's scan goes through ``ops.SSDScan`` (its backward
    recomputes ``ref.ssd_chunked`` once a block), and ``A_log`` gets the
    reference's gradient through it."""
    cid = "smoke-mamba2-370m"
    cfg = CFGS[cid]
    calls = []
    chunked = ssd_ref.ssd_chunked

    def counted(*args, **kwargs):
        calls.append(kwargs["chunk"])
        return chunked(*args, **kwargs)

    with mock.patch.object(ssd_ref, "ssd_chunked", counted):
        _, grads = _grads(cid, _params(cid), _tbatch(_inputs(cfg)))
    assert calls == [min(cfg.chunk_size, S)] * cfg.num_layers
    err = _leaf_errors({"A_log": grads["blocks"]["A_log"]},
                       {"A_log": reference(cid)[2]["blocks"]["A_log"]})
    assert err["['A_log']"] <= REL


# ------------------------------------------------ the SSD Function ----
def _scan_inputs(L, H, P, N, seed=0):
    r = np.random.RandomState(seed)
    buf = r.randn(B, L, H * P + 2 * N).astype(np.float32)
    dt = (0.5 * r.rand(B, L, H) + 0.05).astype(np.float32)
    A = (-0.5 - r.rand(H)).astype(np.float32)
    gy = r.randn(B, L, H, P).astype(np.float32)
    gs = r.randn(B, H, P, N).astype(np.float32)
    return buf, dt, A, gy, gs


def _split(buf, H, P, N):
    x, Bm, Cm = torch.split(buf, [H * P, N, N], dim=-1)
    return x.reshape(*x.shape[:2], H, P), Bm, Cm


@pytest.mark.parametrize("L,H,P,N,chunk", [
    (32, 2, 8, 16, 8), (40, 3, 4, 8, 16), (24, 2, 8, 8, 64)],
    ids=["even", "ragged", "one-chunk"])
def test_ssd_scan_gradient_is_the_references_chunked_gradient(L, H, P, N,
                                                              chunk):
    """``ops.ssd_scan``'s gradient, x/B/C as views of one buffer, against
    ``jax.grad`` of the reference's ``ssd_chunked`` at the kernel's chunk
    (``chunk_len``: 16 lowers to 10 at L = 40), through y and the final
    state; and bitwise autograd through the port's ``ssd_chunked``."""
    buf, dt, A, gy, gs = _scan_inputs(L, H, P, N)
    q = ssd_ops.chunk_len(L, chunk)

    def jloss(buf, dt, A):
        x, Bm, Cm = jnp.split(buf, [H * P, H * P + N], axis=-1)
        y, ex = jmamba2.ssd_chunked(x.reshape(B, L, H, P), dt, A, Bm, Cm,
                                    chunk=q)
        return jnp.sum(y * gy) + jnp.sum(ex.final_state * gs)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(buf, dt, A)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (buf, dt, A)]
    x, Bm, Cm = _split(leaves[0], H, P, N)
    y, state = ssd_ops.ssd_scan(x, leaves[1], leaves[2], Bm, Cm, chunk=chunk)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (state * torch.from_numpy(gs))
        .sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= REL * np.abs(w).max()
    x, Bm, Cm = _split(leaves[0], H, P, N)
    y2, ex = mamba2.ssd_chunked(x, leaves[1], leaves[2], Bm, Cm, chunk=q)
    direct = torch.autograd.grad(
        (y2 * torch.from_numpy(gy)).sum()
        + (ex.final_state * torch.from_numpy(gs)).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


def test_ssd_scan_function_takes_y_alone_and_saves_only_its_inputs():
    """With no gradient for the final state the backward is y's alone;
    the forward on the CPU is the sequential plain version, and the
    graph holds the inputs (the views as given) and nothing else."""
    L, H, P, N = 16, 2, 4, 8
    buf, dt, A, gy, _ = _scan_inputs(L, H, P, N, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (buf, dt, A)]
    x, Bm, Cm = _split(leaves[0], H, P, N)
    y, state = ssd_ops.ssd_scan(x, leaves[1], leaves[2], Bm, Cm, chunk=8)
    with torch.no_grad():
        want_y, want_s = ssd_ref.ssd_scan(x, leaves[1], leaves[2], Bm, Cm)
    assert torch.equal(y, want_y) and torch.equal(state, want_s)
    saved = y.grad_fn.saved_tensors
    base = leaves[0].untyped_storage().data_ptr()
    assert len(saved) == 5 and all(
        t.untyped_storage().data_ptr() == base for t in
        (saved[0], saved[3], saved[4]))
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), leaves)
    y2, _ = mamba2.ssd_chunked(x, leaves[1], leaves[2], Bm, Cm, chunk=8)
    want = torch.autograd.grad((y2 * torch.from_numpy(gy)).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_causal_conv_gradient_matches_the_reference():
    """``mamba2._causal_conv1d`` (row-major out, bias added into it)
    against ``jax.grad`` of the reference's conv, all three inputs."""
    r = np.random.RandomState(4)
    x = r.randn(2, 12, 6).astype(np.float32)
    w = r.randn(4, 6).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    g = r.randn(2, 12, 6).astype(np.float32)
    want = jax.jit(jax.grad(lambda x, w, b: jnp.sum(
        jmamba2._causal_conv1d(x, w, b) * g), argnums=(0, 1, 2)))(x, w, b)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = mamba2._causal_conv1d(*leaves)
    assert out.is_contiguous()
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for a, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert np.abs(a.numpy() - w_).max() <= REL * np.abs(w_).max()


# ------------------------------------------------------------ remat ----
def _counting(module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return mock.patch.object(module, name, counted)


@pytest.mark.parametrize("cid", REMAT_CFGS)
def test_remat_gives_the_same_loss_and_gradients(cid, monkeypatch):
    """``flags.REMAT`` on against off: the same loss and gradients, bit
    for bit, and each rematerialized unit's forward runs twice (the
    scans of every Mamba2 block, the attention of every transformer
    layer; Zamba2's shared attention once an application)."""
    cfg = CFGS[cid]
    params, batch = _params(cid), _tbatch(_inputs(cfg))
    mod, name = ((ssd_ref, "ssd_scan") if not isinstance(
        cfg, TransformerConfig) else (seq_parallel, "chunked_attention"))
    runs = {}
    for remat in (False, True):
        monkeypatch.setattr(flags, "REMAT", remat)
        calls = []
        with _counting(mod, name, calls):
            runs[remat] = _grads(cid, params, batch)
        want = cfg.num_layers * (2 if remat else 1)
        assert len(calls) == want, (remat, len(calls))
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(g0),
                                                 tree_lib.leaves(g1)))


def test_kernel_launches_count_the_recompute(monkeypatch):
    """What ``chip_smoke.py`` gates a training step's ssd_scan launches
    on: a Mamba2 block's forward, once more under remat."""
    m, z = configs.get_config("mamba2-370m"), configs.get_config(
        "zamba2-1.2b")
    assert ssm_lm.kernel_launches(m) == 48
    assert ssm_lm.kernel_launches(m, train=True) == 48
    monkeypatch.setattr(flags, "REMAT", True)
    assert ssm_lm.kernel_launches(m, train=True) == 2 * 48
    assert ssm_lm.kernel_launches(z, train=True) == 2 * 38
    assert ssm_lm.kernel_launches(m) == 48


# ------------------------------------------------- the train step ----
def _batches(cfg, n):
    return [_inputs(cfg, seed=10 + i) for i in range(n)]


@pytest.mark.parametrize("cid", STEP_CFGS)
def test_train_step_matches_the_references_make_lm_train_step(cid):
    """STEPS steps of ``make_lm_train_step`` with the launcher's Adam
    against the reference's own step under ``jax.jit``, from the same
    weights: every loss within 1e-4 relative; the parameters within the
    module docstring's tolerance; the step's inputs left as they were."""
    cfg = CFGS[cid]
    tree = reference(cid)[0]
    jstep, jopt = reference_step(cid)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    opt = Adam(lr=warmup_cosine(*LR, STEPS), grad_clip=1.0)
    step = make_lm_train_step(lm_module(cfg).lm_loss, cfg, None, None, opt)
    p = _params(cid)
    s = opt.init(p)
    first = [t.clone() for t in tree_lib.leaves(p)]
    for i, batch in enumerate(_batches(cfg, STEPS)):
        jp, js, jloss = jstep(jp, js, _jbatch(batch))
        p2, s, loss = step(p, s, _tbatch(batch))
        if i == 0:
            assert all(torch.equal(a, b) for a, b in
                       zip(first, tree_lib.leaves(p)))
        p = p2
        assert abs(loss.item() - float(jloss)) <= REL * abs(float(jloss))
    assert int(s.step) == STEPS
    lr_sum = sum(LR[0] * (t + 1) / LR[1] for t in range(STEPS))
    for (path, got), want in zip(tree_lib.key_paths(p),
                                 jax.tree.leaves(jp)):
        got, want = got.double().numpy(), np.asarray(want, np.float64)
        diff = np.abs(got - want)
        off = diff > REL * max(np.abs(want).max(), 1e-30)
        assert diff.max() <= 2 * lr_sum, (path, diff.max())
        assert off.mean() <= 0.01, (path, off.mean())


def test_train_step_raises_for_a_mesh_or_policy():
    """A policy whose mesh is None is no policy: the unsharded step. A
    mesh without a policy over it raises, a process mesh raises naming
    the next slice, and over an in-process mesh the sharded step runs
    (per-shard trees in, per-shard trees out;
    tests/test_torch_lm_sharded.py holds it to the reference)."""
    cfg = CFGS["dense"]
    opt = Adam(lr=warmup_cosine(*LR, STEPS))
    batch = _tbatch(_inputs(cfg))
    params = _params("dense")
    unsharded = make_lm_train_step(transformer.lm_loss, cfg, None, None, opt)
    step = make_lm_train_step(transformer.lm_loss, cfg, None,
                              ShardingPolicy(mesh=None), opt)
    assert torch.equal(step(params, opt.init(params), batch)[2],
                       unsharded(params, opt.init(params), batch)[2])
    mesh = Mesh((("data", 1), ("model", 2)), ["cpu"] * 2)
    with pytest.raises(ValueError, match="ShardingPolicy"):
        make_lm_train_step(transformer.lm_loss, cfg, mesh, None, opt)
    procs = object.__new__(ProcessMesh)
    with pytest.raises(NotImplementedError, match="next slice"):
        make_lm_train_step(transformer.lm_loss, cfg, procs,
                           ShardingPolicy(mesh=procs), opt)
    policy = ShardingPolicy(mesh=mesh, plan="tp")
    step = make_lm_train_step(transformer.lm_loss, cfg, mesh, policy, opt)
    specs = infer_param_specs(transformer.param_shapes(cfg), policy)
    shards = shard_tree(params, specs, mesh)
    new, states, loss = step(shards, [opt.init(p) for p in shards], batch)
    assert len(new) == len(states) == 2 and bool(torch.isfinite(loss))
    assert int(states[1].step) == 1


def test_token_dataset_is_the_references_bitwise():
    for args in ((5_000, 97, 0), (3_000, 50_280, 3)):
        got, want = make_token_dataset(*args), jmake_token_dataset(*args)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


# ----------------------------------------------------------- drivers ----
def _reference_launcher_losses(cid, seq, batch):
    """The reference launcher's LM loop (``repro.launch.train.main`` with
    no mesh) step by step: its parameters (``init_params`` at
    ``PRNGKey(0)``), optimizer, corpus and numpy batch draw, the step
    the reference's ``make_lm_train_step`` (what its loop jits)."""
    cfg = CFGS[cid]
    jstep, jopt = reference_step(cid)
    params = _jmod(cfg).init_params(jax.random.PRNGKey(0), _jcfg(cfg))
    tree = jax.tree.map(np.asarray, params)
    state = jopt.init(params)
    toks = jmake_token_dataset(100_000, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(STEPS):
        starts = rng.integers(0, len(toks) - seq - 1, batch)
        x = np.stack([toks[s:s + seq] for s in starts])
        y = np.stack([toks[s + 1:s + seq + 1] for s in starts])
        params, state, loss = jstep(params, state, {
            "tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
        losses.append(float(loss))
    return tree, losses


@pytest.mark.parametrize("cid", ["smoke-mamba2-370m", "smoke-phi3.5-moe"])
def test_launcher_lm_loop_gives_the_references_losses(cid, capsys):
    """``launch.train.train_lm`` started from the reference's parameters
    gives the reference loop's step losses (1e-4 relative) and prints
    them."""
    arch = cid[len("smoke-"):]
    tree, want = _reference_launcher_losses(cid, S, B)
    args = launch_train.parse_args(["--arch", arch, "--steps", str(STEPS),
                                    "--batch", str(B), "--seq", str(S),
                                    "--device", "cpu"])
    _, got = launch_train.train_lm(args, CFGS[cid], _params(cid, tree))
    assert len(got) == STEPS
    assert all(abs(g - w) <= REL * abs(w) for g, w in zip(got, want)), (
        got, want)
    out = capsys.readouterr().out
    assert f"step    0  loss {got[0]:.3f}" in out


def test_launcher_trains_every_kind_from_its_own_init(capsys):
    """``main`` on a hybrid (with ``--remat``) and hubert's frames: finite
    losses, every step printed at the end; REMAT restored after."""
    for arch, extra in (("zamba2-1.2b", ["--remat"]),
                        ("hubert-xlarge", [])):
        launch_train.main(["--arch", arch, "--steps", "2", "--seq", "16",
                           "--batch", "2", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "step    1  loss" in out and "nan" not in out
    assert flags.REMAT is False


def test_serve_lm_trains_then_generates(capsys):
    out = serve_lm.main(["--arch", "mamba2-370m", "--train-steps", "3",
                         "--batch", "2", "--gen-steps", "4",
                         "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int64
    text = capsys.readouterr().out
    assert "train step   2 loss" in text and "req1: prompt=" in text


def test_lm_batches_follow_the_reference_draw():
    """The launcher's batches: the reference's windows of the corpus;
    hubert's tokens replaced by frames of the batch's shape."""
    cfg = CFGS["smoke-qwen1.5-0.5b"]
    toks = jmake_token_dataset(100_000, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    for got in launch_train.lm_batches(cfg, 3, 8, 2, "cpu"):
        starts = rng.integers(0, len(toks) - 9, 3)
        assert np.array_equal(got["tokens"].numpy(),
                              np.stack([toks[s:s + 8] for s in starts]))
        assert np.array_equal(got["labels"].numpy(),
                              np.stack([toks[s + 1:s + 9] for s in starts]))
    hubert = CFGS["smoke-hubert-xlarge"]
    frames = next(launch_train.lm_batches(hubert, 2, 8, 1, "cpu"))["tokens"]
    assert frames.shape == (2, 8, hubert.d_model)
    assert frames.is_floating_point()
    assert 0.05 < frames.std().item() < 0.2
    assert isinstance(launch_train.parse_args(["--arch", "qwen1.5-0.5b"]),
                      argparse.Namespace)
