"""Sharded language-model training and serving in the port against the
reference, on the CPU, over in-process meshes of CPU shards.

* The loss and EVERY gradient leaf of the dense, GQA (qwen-like, with
  biases and tied embeddings), gemma-like (local/global windows,
  softcaps), Mamba2, hybrid (Zamba2 SMOKE and one whose layers do not
  divide into groups), MoE (and arctic-like), encoder and VLM configs
  under ``tp``, ``cp`` and ``ep`` at 1 x 2, 2 x 2 and 1 x 4, against the
  reference's UNSHARDED ``jax.value_and_grad(lm_loss)`` (the reference's
  contract: a sharded step equals the unsharded one): the loss within
  1e-4 relative, each leaf within 1e-4 of its max-abs. The MoE layers
  under ``ep`` take the gathered route here (``flags.EP_ALLTOALL`` off:
  the reference's ``moe_ffn`` on the global tokens); with the
  ``all_to_all``s (``moe_ffn_ep``, whose drops and aux loss are each
  shard's own) they are held to the reference's SHARDED gradients.
* One Adam step (grad_clip 1.0) at 2 x 4 under ``tp`` and ``cp``
  against the reference's sharded step (``tests/test_multidevice.py:179``'s
  case and tolerances: loss 2e-4, parameters rtol 3e-3 atol 3e-4).
* FSDP (phi3.5-moe SMOKE with d_ff 1,024, so that the experts' d_ff
  cuts over the data axis); remat on against off under a mesh (bitwise:
  the recompute runs the same operations on the same inputs through
  ``spmd.checkpoint``); the sharded clip norm against the global tree's
  norm; sharded ``generate`` against the unsharded tokens under ``cp``
  and ``tp`` at 1 x 2 and 1 x 4, and ``max_len`` that does not divide
  raising; the launcher at ``--data 2 --model 2`` for each ``--plan``
  against the reference launcher's step losses from the same
  parameters (1e-4 relative).

The reference's sharded runs go in one JAX subprocess with 8 host
devices, started before the first test, beside the port-only tests;
its unsharded references are computed in this process on first use
(``tests/test_torch_lm_train.py``'s ``reference``: the same weights,
every zero-initialized vector replaced by seeded draws, and inputs).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_lm_train as base
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.configs.base import TransformerConfig
from repro_torch.core import flags, sharding, spmd
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm_module, transformer
from repro_torch.optim.adam import Adam, constant, global_norm
from repro_torch.serve import lm
from repro_torch.train.train_step import (lm_sharded_value_and_grad,
                                          make_lm_train_step)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PLANS = ("tp", "cp", "ep")
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
GRAD_CFGS = ["dense", "qwen-like", "gemma-like", "smoke-mamba2-370m",
             "smoke-zamba2-1.2b", "hybrid-odd", "smoke-phi3.5-moe",
             "arctic-like", "encoder-like", "vlm-like"]
EP_MESHES = ((1, 2), (2, 2))
# the launcher at --data 2 --model 2: an arch a plan (the hybrid's heads
# and gathered Mamba2 weights, the context-parallel scan and halo, the
# expert all_to_all)
LAUNCH = {"tp": "zamba2-1.2b", "cp": "mamba2-370m", "ep": "phi3.5-moe"}
LAUNCH_ARGS = ("--steps", "3", "--batch", "4", "--seq", "16")
# the reference's tests/test_multidevice.py:179 configuration
MD_CFG = TransformerConfig(name="t", family="dense", num_layers=2,
                           d_model=64, num_heads=4, num_kv_heads=4,
                           d_ff=128, vocab_size=96)

REFERENCE = r'''
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro import configs as jconfigs
from repro.configs.base import TransformerConfig
from repro.core import compat
from repro.core.sharding import ShardingPolicy
from repro.data.synthetic import make_token_dataset
from repro.models import ssm_lm, transformer as T
from repro.optim.adam import Adam, constant, warmup_cosine
out = {}

def mesh_of(d, m):
    return compat.make_mesh((d, m), ("data", "model"))

# 1. tests/test_multidevice.py:179's case: one Adam step at 2 x 4
cfg = TransformerConfig(name="t", family="dense", num_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=96)
params = T.init_params(jax.random.PRNGKey(0), cfg)
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, 96)
batch = {"tokens": toks, "labels": toks}
opt = Adam(lr=constant(1e-3), grad_clip=1.0)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["md_init" + jax.tree_util.keystr(path)] = leaf
out["md_tokens"] = toks
mesh = mesh_of(2, 4)
for plan in ("tp", "cp"):
    policy = ShardingPolicy(mesh=mesh, plan=plan)

    def step(p, o, b, policy=policy):
        loss, g = jax.value_and_grad(T.lm_loss)(p, b, cfg, policy, mesh)
        return opt.update(g, o, p)[0], loss

    with compat.set_mesh(mesh):
        new, loss = jax.jit(step)(params, opt.init(params), batch)
    out[f"md_{plan}_loss"] = loss
    for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
        out[f"md_{plan}" + jax.tree_util.keystr(path)] = leaf

# 2. phi3.5-moe SMOKE under ep with the expert all_to_all
cfg = jconfigs.get_smoke_config("phi3.5-moe")
EP = dict(np.load(EP_INPUTS))
p = {"layers": {}}
for name, a in EP.items():
    if name.startswith("p."):
        keys = name[2:].split(".")
        node = p
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(a)
b = {"tokens": jnp.asarray(EP["tokens"]), "labels": jnp.asarray(EP["labels"])}
for d, m in EP_MESHES:
    mesh = mesh_of(d, m)
    policy = ShardingPolicy(mesh=mesh, plan="ep")
    with compat.set_mesh(mesh):
        loss, g = jax.jit(lambda p, b: jax.value_and_grad(T.lm_loss)(
            p, b, cfg, policy, mesh))(p, b)
    out[f"ep_{d}x{m}_loss"] = loss
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[f"ep_{d}x{m}" + jax.tree_util.keystr(path)] = leaf

# 3. the reference launcher's LM loop at --data 2 --model 2
mesh = mesh_of(2, 2)
for plan, arch in LAUNCH.items():
    cfg = jconfigs.get_smoke_config(arch)
    policy = ShardingPolicy(mesh=mesh, plan=plan)
    mod = ssm_lm if arch in ("zamba2-1.2b", "mamba2-370m") else T
    params = mod.init_params(jax.random.PRNGKey(0), cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"launch_{plan}_init" + jax.tree_util.keystr(path)] = leaf
    opt = Adam(lr=warmup_cosine(3e-3, 10, STEPS), grad_clip=1.0)
    state = opt.init(params)

    @jax.jit
    def step(p, s, batch):
        loss, g = jax.value_and_grad(mod.lm_loss)(p, batch, cfg, policy,
                                                  mesh)
        p, s = opt.update(g, s, p)
        return p, s, loss

    toks = make_token_dataset(100_000, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    losses = []
    with compat.set_mesh(mesh):
        for i in range(STEPS):
            starts = rng.integers(0, len(toks) - SEQ - 1, BATCH)
            x = np.stack([toks[s:s + SEQ] for s in starts])
            y = np.stack([toks[s + 1:s + SEQ + 1] for s in starts])
            params, state, loss = step(params, state, {
                "tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
            losses.append(float(loss))
    out[f"launch_{plan}_losses"] = np.asarray(losses)
np.savez(OUT, **{n: np.asarray(a) for n, a in out.items()})
'''


class _Pending:
    """The reference's subprocess, started at once; ``result()`` waits
    for it (the port-only tests run meanwhile) and loads its outputs."""

    def __init__(self, script: str, path: str):
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import os; os.nice(10)\n" + script],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self.path, self.out = path, None

    def result(self) -> dict:
        if self.out is None:
            stdout, stderr = self.proc.communicate(timeout=560)
            assert self.proc.returncode == 0, (stdout, stderr)
            self.out = dict(np.load(self.path))
        return self.out


def _ep_inputs() -> dict:
    """phi3.5-moe SMOKE's reference weights (the unsharded reference's)
    and batch, flat by dotted path, for the subprocess."""
    cid = "smoke-phi3.5-moe"
    tree = base.reference(cid)[0]
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["p." + ".".join(path + (k,))] = np.asarray(v)
    walk(tree, ())
    batch = base._inputs(base.CFGS[cid])
    return dict(flat, tokens=batch["tokens"], labels=batch["labels"])


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_sharded")
    path_in, path = str(root / "ep.npz"), str(root / "reference.npz")
    np.savez(path_in, **_ep_inputs())
    script = (f"EP_INPUTS = {path_in!r}\nOUT = {path!r}\n"
              f"EP_MESHES = {EP_MESHES!r}\nLAUNCH = {LAUNCH!r}\n"
              f"STEPS = {base.STEPS}\nBATCH = 4\nSEQ = 16\n" + REFERENCE)
    pending = _Pending(script, path)
    yield pending
    if pending.proc.poll() is None:
        pending.proc.kill()
        pending.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small
    (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(d, m):
    return Mesh((("data", d), ("model", m)), ["cpu"] * (d * m))


def _unflat(out: dict, prefix: str) -> dict:
    """The reference's tree saved under ``prefix`` + keystr paths."""
    tree: dict = {}
    for name, a in out.items():
        if not name.startswith(prefix + "["):
            continue
        keys = [k.strip("'") for k in name[len(prefix) + 1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.from_numpy(np.array(a))
    return tree


def _sharded(cfg, params, batch, plan, d, m, **policy_kw):
    """(loss, the joined gradient tree, the policy) of one sharded
    ``lm_sharded_value_and_grad`` from global ``params`` and ``batch``."""
    mod = lm_module(cfg)
    mesh = _mesh(d, m)
    policy = sharding.ShardingPolicy(mesh, plan=plan, **policy_kw)
    specs = infer_param_specs(mod.param_shapes(cfg), policy)
    rows = {n: sharding.shard_rows(v, policy) for n, v in batch.items()}
    batches = [{n: v[r] for n, v in rows.items()} for r in range(mesh.size)]
    loss, grads = lm_sharded_value_and_grad(
        mod.lm_loss, sharding.shard_tree(params, specs, mesh), batches, cfg,
        policy, specs)
    return loss, sharding.join_shards(grads, specs, mesh), policy


def _check(loss, grads, want_loss, want_grads, tol=1e-4):
    want_loss = float(want_loss)
    assert abs(loss.item() - want_loss) <= tol * abs(want_loss), (
        loss.item(), want_loss)
    errs = base._leaf_errors(grads, want_grads)
    assert max(errs.values()) <= tol, errs


# --------------------------------------------- the port alone, first ----
@pytest.mark.parametrize("cid", ["dense", "gemma-like", "smoke-mamba2-370m",
                                 "hybrid-odd", "smoke-phi3.5-moe"])
@pytest.mark.parametrize("plan", ["tp", "cp"])
def test_remat_under_a_mesh_is_bitwise(cid, plan, monkeypatch):
    """``flags.REMAT`` on against off at 1 x 2: the same loss and every
    gradient leaf, bit for bit (each layer's recompute runs through
    ``spmd.checkpoint`` on every shard, meeting the same collectives; a
    per-shard ``torch.utils.checkpoint`` would recompute its psums and
    gathers as local operations, far off). One case is not bitwise:
    the hybrid whose Mamba2 blocks follow a shared-attention application,
    under ``cp`` (1.6e-6 of a leaf's scale in fp32, 1.7e-15 in fp64: a
    rounding, not a fault). A tensor there collects three or more
    cotangents (the residual, the norm's two uses, the halo's), and the
    autograd engine adds them in the order it reaches their nodes, which
    differs between the whole graph and a recompute's nested one; it is
    held at 1e-5 of each leaf's scale."""
    cfg = base.CFGS[cid]
    params, batch = base._params(cid), base._tbatch(base._inputs(cfg))
    runs = []
    for remat in (False, True):
        monkeypatch.setattr(flags, "REMAT", remat)
        runs.append(_sharded(cfg, params, batch, plan, 1, 2)[:2])
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    if (cid, plan) == ("hybrid-odd", "cp"):
        errs = base._leaf_errors(g1, tree_lib.tree_map(
            lambda t: t.numpy(), g0))
        assert max(errs.values()) <= 1e-5, errs
        return
    for (path, a), b in zip(tree_lib.key_paths(g0), tree_lib.leaves(g1)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("plan", PLANS)
def test_sharded_clip_norm_counts_each_leaf_once(plan):
    """Inside the step's update, each shard's clip norm (``global_norm``
    with each leaf's axes) equals the norm of the global gradient tree:
    a leaf whole on every shard counted once, a cut leaf's blocks
    summed over the axes that cut it."""
    cid = "smoke-phi3.5-moe"
    cfg = base.CFGS[cid]
    params, batch = base._params(cid), base._tbatch(base._inputs(cfg))
    mesh = _mesh(2, 2)
    policy = sharding.ShardingPolicy(mesh, plan=plan)
    specs = infer_param_specs(transformer.param_shapes(cfg), policy)
    grads = [tree_lib.tree_map(lambda t: t + 1.0, s)  # no zero leaf
             for s in sharding.shard_tree(params, specs, mesh)]
    axes = [sharding.named_axes(s) for s in sharding.flat_specs(
        transformer.param_shapes(cfg), specs)]
    assert {a for a in axes} >= {(), ("model",)}
    norms = spmd.run(mesh, lambda g: global_norm(g, leaf_axes=axes), grads)
    want = global_norm(sharding.join_shards(grads, specs, mesh))
    for n in norms:
        assert abs(n.item() - want.item()) <= 1e-6 * want.item()


@pytest.mark.parametrize("cid", ["qwen-like", "gemma-like",
                                 "smoke-mamba2-370m", "smoke-zamba2-1.2b",
                                 "smoke-phi3.5-moe"])
@pytest.mark.parametrize("plan", ["cp", "tp"])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_sharded_generate_gives_the_unsharded_tokens(cid, plan, mesh):
    """Greedy tokens over the mesh (its prefill's keys and values moved
    into the sequence-cut cache, ``max_len / n`` slots a shard; every
    decode step's sharded merge) against the unsharded ``generate``."""
    cfg = base.CFGS[cid]
    params = base._params(cid)
    prompts = torch.from_numpy(base._inputs(cfg)["tokens"][:, :12])
    want = lm.generate(params, prompts, cfg, 4)
    d, m = MESHES[mesh]
    got = lm.generate(params, prompts, cfg, 4, policy=sharding.ShardingPolicy(
        _mesh(d, m), plan=plan))
    assert torch.equal(got, want)


def test_a_max_len_that_does_not_divide_raises():
    cid = "smoke-zamba2-1.2b"
    cfg = base.CFGS[cid]
    prompts = torch.from_numpy(base._inputs(cfg)["tokens"][:, :5])
    with pytest.raises(ValueError, match="does not cut into 2"):
        lm.generate(base._params(cid), prompts, cfg, 4,
                    policy=sharding.ShardingPolicy(_mesh(1, 2), plan="cp"))


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("cid", GRAD_CFGS)
def test_loss_and_every_gradient_match_the_unsharded_reference(
        cid, plan, mesh, monkeypatch):
    monkeypatch.setattr(flags, "EP_ALLTOALL", False)
    cfg = base.CFGS[cid]
    _, want_loss, want_grads = base.reference(cid)
    loss, grads, _ = _sharded(cfg, base._params(cid),
                              base._tbatch(base._inputs(cfg)), plan,
                              *MESHES[mesh])
    _check(loss, grads, want_loss, want_grads)


def test_fsdp_cuts_over_the_data_axis_and_matches_the_reference():
    """phi3.5-moe SMOKE with d_ff 1,024 under ``tp`` with ``fsdp`` at
    2 x 2: the experts' d_ff cut over data (gathered before use, the
    adjoint summing over data), the loss and every gradient leaf against
    the reference's unsharded ``value_and_grad`` (computed here)."""
    cfg = dataclasses.replace(base.CFGS["smoke-phi3.5-moe"], d_ff=1024)
    policy = sharding.ShardingPolicy(_mesh(2, 2), plan="tp", fsdp=True)
    specs = infer_param_specs(transformer.param_shapes(cfg), policy)
    assert specs["layers"]["w_up_e"] == (None, "model", None, "data")
    jcfg = base._jcfg(cfg)
    draws = {p: jax.numpy.asarray(v) for p, v in base._draws(cfg).items()}

    def program(key, batch):
        p = base._replace(jtransformer.init_params(key, jcfg), draws)
        loss, g = jax.value_and_grad(jtransformer.lm_loss)(p, batch, jcfg)
        return p, loss, g

    batch = base._inputs(cfg)
    tree, want_loss, want_grads = jax.tree.map(np.asarray, base._jit(
        program)(jax.random.PRNGKey(0), base._jbatch(batch)))
    params = transformer.params_from_numpy(tree, cfg, device="cpu")
    loss, grads, _ = _sharded(cfg, params, base._tbatch(batch), "tp", 2, 2,
                              fsdp=True)
    _check(loss, grads, want_loss, want_grads)


@pytest.mark.parametrize("mesh", EP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_all_to_all_matches_the_references_sharded_gradients(
        mesh, reference):
    """Under ``ep`` with ``flags.EP_ALLTOALL`` (each shard's own routing,
    capacity and aux loss, two ``all_to_all``s) against the reference's
    sharded ``value_and_grad`` over the same mesh: loss and every leaf
    1e-4."""
    cid = "smoke-phi3.5-moe"
    cfg = base.CFGS[cid]
    d, m = mesh
    loss, grads, _ = _sharded(cfg, base._params(cid),
                              base._tbatch(base._inputs(cfg)), "ep", d, m)
    out = reference.result()
    want = _unflat(out, f"ep_{d}x{m}")
    _check(loss, grads, out[f"ep_{d}x{m}_loss"],
           tree_lib.tree_map(lambda t: t.numpy(), want))


@pytest.mark.parametrize("plan", ["tp", "cp"])
def test_one_adam_step_matches_the_references_sharded_step(plan, reference):
    """``make_lm_train_step`` at 2 x 4 (the reference's
    tests/test_multidevice.py:179 case, Adam with grad_clip 1.0) from
    the reference's initial parameters: loss 2e-4, every parameter rtol
    3e-3, atol 3e-4."""
    out = reference.result()
    params = _unflat(out, "md_init")
    batch = {"tokens": torch.from_numpy(out["md_tokens"])}
    batch["labels"] = batch["tokens"]
    mesh = _mesh(2, 4)
    policy = sharding.ShardingPolicy(mesh, plan=plan)
    opt = Adam(lr=constant(1e-3), grad_clip=1.0)
    step = make_lm_train_step(transformer.lm_loss, MD_CFG, mesh, policy, opt)
    specs = infer_param_specs(transformer.param_shapes(MD_CFG), policy)
    shards = sharding.shard_tree(params, specs, mesh)
    new, _, loss = step(shards, [opt.init(p) for p in shards], batch)
    assert abs(loss.item() - float(out[f"md_{plan}_loss"])) < 2e-4
    got = sharding.join_shards(new, specs, mesh)
    want = _unflat(out, f"md_{plan}")
    for (path, a), b in zip(tree_lib.key_paths(got), tree_lib.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3,
                                   atol=3e-4, err_msg=path)


@pytest.mark.parametrize("plan", PLANS)
def test_launcher_gives_the_reference_launchers_losses(plan, reference,
                                                       capsys):
    """``launch.train.train_lm`` at ``--data 2 --model 2 --plan`` from the
    reference launcher's initial parameters: each step's loss within
    1e-4 of the reference launcher's over the same mesh."""
    arch = LAUNCH[plan]
    cfg = configs.get_smoke_config(arch)
    out = reference.result()
    params = lm_module(cfg).params_from_numpy(
        tree_lib.tree_map(lambda t: t.numpy(),
                          _unflat(out, f"launch_{plan}_init")), cfg,
        device="cpu")
    args = launch_train.parse_args(
        ["--arch", arch, *LAUNCH_ARGS, "--data", "2", "--model", "2",
         "--plan", plan, "--device", "cpu"])
    _, got = launch_train.train_lm(args, cfg, params)
    want = out[f"launch_{plan}_losses"]
    assert len(got) == len(want)
    assert all(abs(g - w) <= base.REL * abs(w) for g, w in zip(got, want)), (
        got, want)
    assert f"plan {plan}, mesh 2x2" in capsys.readouterr().out
