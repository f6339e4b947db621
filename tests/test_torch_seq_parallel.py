"""The port's sharding policies, parameter specs and sequence-parallel
functions against the reference's, on the CPU.

* ``ShardingPolicy.rules()`` / ``spec()`` for every logical name and
  plan (the reference's ``seq_shard_acts`` off: the port has no such
  flag yet), and the layout the models read from them (``seq_split``,
  ``data_spec``); ``infer_param_specs`` leaf for leaf at every full LM
  config (the reference's tree from ``jax.eval_shape``, a mesh stand-in
  with only ``.shape``: its ``_leaf_spec`` reads nothing else);
  ``PLANS`` / ``plan_for``.
* ``cp_attention`` (full; windows 8, 20, 48 at ``kv_chunk`` 16 over 4
  shards, so that a window takes several hops), ``cp_ssd`` (chunk 8
  against the reference's unsharded chunk 16 and its own cp_ssd),
  ``decode_attention_sharded_kv``, ``cache_update_sharded``,
  ``tp_attention`` and ``moe_ffn_ep`` (capacity 8.0 and the default
  1.25, where tokens drop), each against the reference's own function,
  which runs in one JAX subprocess with 8 host devices (started before
  this file's first test, beside the port-only tests, at a lowered
  priority); the shapes and tolerances of the reference's
  ``tests/test_multidevice.py:57,88,224``.
* The gradients of ``cp_attention`` and ``cp_ssd`` against the
  unsharded ones, at 1e-4 of each gradient's scale; ``pmax``; the
  helpers that cut and join trees.

The port's functions are per-shard: each test cuts the global inputs
into the shards' blocks, runs ``spmd.run`` over an in-process mesh of
CPU shards and puts the outputs back together.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import param_specs as jparam_specs
from repro.core.sharding import ShardingPolicy as JPolicy
from repro.models import ssm_lm as jssm_lm
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.core import seq_parallel, sharding, spmd
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers, moe
from repro_torch.models import lm_module

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAMES = ("act_bsd", "act_bsv", "kv_cache", "emb_vd", "pos", "act_bshd",
         "act_bsf", "w_dhd", "w_hdd", "w_df", "w_fd", "w_edf", "w_efd",
         "act_ecd", "ssm_state", "act_bshp", "not_a_name")
PLANS = ("tp", "cp", "ep")
WINDOWS = (0, 8, 20, 48)
CAPACITIES = (8.0, 1.25)

REFERENCE = r'''
import numpy as np, jax, jax.numpy as jnp
from repro.core import compat
from repro.core.seq_parallel import (cp_attention, cp_ssd, tp_attention,
                                     decode_attention_sharded_kv,
                                     cache_update_sharded)
from repro.core.sharding import ShardingPolicy
from repro.models import moe as moe_lib
from repro.models.mamba2 import ssd_chunked
IN = dict(np.load(INPUTS))
out = {}
m4 = compat.make_mesh((4,), ("model",))
q, k, v = (jnp.asarray(IN[n]) for n in ("q", "k", "v"))
for w in WINDOWS:
    out[f"cp_attention_{w}"] = jax.jit(lambda q, k, v: cp_attention(
        q, k, v, m4, "model", causal=True, window=w, kv_chunk=16))(q, k, v)
x, dt, A, Bm, Cm = (jnp.asarray(IN[n]) for n in ("x", "dt", "A", "Bm", "Cm"))
out["ssd_chunked_16"] = ssd_chunked(x, dt, A, Bm, Cm, chunk=16)[0]
out["cp_ssd"] = jax.jit(lambda x, dt, Bm, Cm: cp_ssd(
    x, dt, A, Bm, Cm, m4, "model", chunk=8))(x, dt, Bm, Cm)
kc, vc, q1, new = (jnp.asarray(IN[n]) for n in ("kc", "vc", "q1", "new"))
out["decode"] = jax.jit(lambda q, k, v: decode_attention_sharded_kv(
    q, k, v, CUR, m4, "model"))(q1, kc, vc)
out["cache"] = jax.jit(lambda c, n: cache_update_sharded(
    c, n, CUR, m4, "model"))(kc, new)
m14 = compat.make_mesh((1, 4), ("data", "model"))
qt, kt, vt = (jnp.asarray(IN[n]) for n in ("qt", "kt", "vt"))
out["tp_attention"] = jax.jit(lambda q, k, v: tp_attention(
    q, k, v, m14, "model", data_axes=("data",), causal=True,
    kv_chunk=16))(qt, kt, vt)
m24 = compat.make_mesh((2, 4), ("data", "model"))
policy = ShardingPolicy(mesh=m24, plan="ep")
p = {n: jnp.asarray(IN["moe_" + n])
     for n in ("router", "w_gate", "w_up", "w_down")}
xm = jnp.asarray(IN["moe_x"])
with compat.set_mesh(m24):
    for cap in CAPACITIES:
        y, aux = jax.jit(lambda p, x: moe_lib.moe_ffn_ep(
            p, x, num_experts=4, top_k=2, mesh=m24, policy=policy,
            capacity_factor=cap))(p, xm)
        out[f"moe_ep_{cap}"], out[f"moe_ep_aux_{cap}"] = y, aux
out["moe_8.0"] = moe_lib.moe_ffn(p, xm, num_experts=4, top_k=2,
                                 capacity_factor=8.0)[0]
np.savez(OUT, **{n: np.asarray(a) for n, a in out.items()})
'''

CUR = 37


def _inputs() -> dict:
    """Every input, numpy, seeded: the reference's test shapes."""
    r = np.random.RandomState(11)
    f = np.float32
    B, S, H, Hkv, hd = 2, 64, 8, 4, 16
    P_, N = 8, 16
    out = {"q": r.randn(B, S, H, hd), "k": r.randn(B, S, Hkv, hd),
           "v": r.randn(B, S, Hkv, hd),
           "x": r.randn(B, S, 4, P_),
           "dt": np.log1p(np.exp(r.randn(B, S, 4))),
           "A": -np.exp(0.5 * r.randn(4)), "Bm": r.randn(B, S, N),
           "Cm": r.randn(B, S, N),
           "kc": r.randn(B, S, 4, hd), "vc": r.randn(B, S, 4, hd),
           "q1": r.randn(B, 1, 8, hd), "new": r.randn(B, 1, 4, hd),
           "qt": r.randn(4, 32, 8, 16), "kt": r.randn(4, 32, 2, 16),
           "vt": r.randn(4, 32, 2, 16),
           "moe_x": r.randn(4, 32, 32),
           "moe_router": r.randn(32, 4) / np.sqrt(32),
           "moe_w_gate": r.randn(4, 32, 64) / np.sqrt(32),
           "moe_w_up": r.randn(4, 32, 64) / np.sqrt(32),
           "moe_w_down": r.randn(4, 64, 32) / np.sqrt(64)}
    return {n: a.astype(f) for n, a in out.items()}


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


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory, inputs):
    root = tmp_path_factory.mktemp("seq_parallel")
    path_in, path = str(root / "inputs.npz"), str(root / "reference.npz")
    np.savez(path_in, **inputs)
    script = (f"INPUTS = {path_in!r}\nOUT = {path!r}\nCUR = {CUR}\n"
              f"WINDOWS = {WINDOWS!r}\nCAPACITIES = {CAPACITIES!r}\n"
              + REFERENCE)
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


class _MeshShape:
    """A mesh stand-in with only ``.shape`` (what the specs read)."""

    def __init__(self, **shape):
        self.shape = dict(shape)


def _spec(p) -> tuple:
    return tuple(p)


def _mesh(*axes):
    return Mesh(axes, ["cpu"] * int(np.prod([n for _, n in axes])))


def _blocks(t, spec, mesh):
    return [sharding.block(t, spec, mesh, r) for r in range(mesh.size)]


def _joined(outs, spec, mesh):
    return sharding.join_shards(list(outs), spec, mesh)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# --------------------------------------------- the port alone, first ----
def test_pmax_is_the_max_in_rank_order_and_has_no_gradient():
    mesh = _mesh(("data", 2), ("model", 2))
    xs = [torch.randn(3, 5, generator=torch.Generator().manual_seed(r),
                      requires_grad=True) for r in range(4)]
    outs = spmd.run(mesh, lambda x: spmd.axis("model").pmax(x), xs)
    for r, out in enumerate(outs):
        row = (r // 2) * 2
        assert torch.equal(out, torch.maximum(xs[row], xs[row + 1]))
        assert not out.requires_grad
    alone = spmd.axis("model").pmax(xs[0])  # outside a run: one shard
    assert torch.equal(alone, xs[0]) and not alone.requires_grad


def test_no_mesh_is_no_policy_and_trees_cut_and_join():
    assert not sharding.sharded_policy(sharding.ShardingPolicy(mesh=None))
    assert sharding.NO_POLICY.model_size == 1
    mesh = _mesh(("data", 2), ("model", 2))
    cfg = configs.get_smoke_config("phi3.5-moe")
    mod = lm_module(cfg)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for plan in PLANS:
        policy = sharding.ShardingPolicy(mesh, plan=plan, fsdp=True)
        specs = infer_param_specs(params, policy)
        shards = sharding.shard_tree(params, specs, mesh)
        flat = sharding.flat_specs(params, specs)
        for shard in shards:
            for t, whole, s in zip(tree_lib.leaves(shard),
                                   tree_lib.leaves(params), flat):
                cut = np.prod([mesh.degree(a)
                               for a in sharding.named_axes(s)])
                assert t.numel() * cut == whole.numel()
        back = sharding.join_shards(shards, specs, mesh)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(back), tree_lib.leaves(params)))


@pytest.mark.parametrize("fn", ["cp_attention", "cp_ssd"])
def test_gradients_match_the_unsharded_ones(fn, inputs):
    """The gradient of sum(out * ct) with respect to every input, over 4
    shards, against the unsharded function's: 1e-4 of each gradient's
    max-abs."""
    mesh = _mesh(("model", 4))
    if fn == "cp_attention":
        names, kw = ("q", "k", "v"), dict(window=20)
    else:
        names, kw = ("x", "dt", "Bm", "Cm"), {}
    full = [torch.from_numpy(inputs[n]).double() for n in names]
    A = torch.from_numpy(inputs["A"]).double()
    specs = [(None, "model")] * len(names)
    leaves = [[b.clone().requires_grad_() for b in _blocks(t, s, mesh)]
              for t, s in zip(full, specs)]

    def shard(*args):
        if fn == "cp_attention":
            return seq_parallel.cp_attention(*args, "model", kv_chunk=16,
                                             **kw)
        x, dt, Bm, Cm = args
        return seq_parallel.cp_ssd(x, dt, A, Bm, Cm, "model", chunk=8)

    outs = spmd.run(mesh, shard, *leaves)
    ct = torch.randn(_joined([o.detach() for o in outs], (None, "model"),
                             mesh).shape,
                     generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64)
    cts = _blocks(ct, (None, "model"), mesh)
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)),
                              [t for ls in leaves for t in ls])
    ref_in = [t.clone().requires_grad_() for t in full]
    if fn == "cp_attention":
        pos = torch.arange(ref_in[0].shape[1])
        want = layers.chunked_attention(*ref_in, q_pos=pos, kv_pos=pos,
                                        causal=True, kv_chunk=16, **kw)
    else:
        want = ssd_ref.ssd_chunked(*ref_in[:2], A, *ref_in[2:], chunk=16)[0]
    wants = torch.autograd.grad((want * ct).sum(), ref_in)
    for i, w in enumerate(wants):
        g = _joined(got[i * 4:(i + 1) * 4], (None, "model"), mesh)
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * scale, names[i]


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
def test_rules_and_specs_match_the_reference(plan, data_axes):
    from repro.core import flags as jflags

    for model in (1, 4):
        shape = dict(pod=2, data=4, model=model)
        for fsdp in (False, True):
            with jflags.flags(seq_shard_acts=False):
                want = JPolicy(mesh=_MeshShape(**shape), plan=plan,
                               data_axes=data_axes, fsdp=fsdp)
                want_rules = {n: _spec(p) for n, p in want.rules().items()}
                want_specs = {n: _spec(want.spec(n)) for n in NAMES}
            got = sharding.ShardingPolicy(
                mesh=_MeshShape(**shape), plan=plan, data_axes=data_axes,
                fsdp=fsdp)
            assert got.rules() == want_rules
            assert {n: got.spec(n) for n in NAMES} == want_specs
            assert got.model_size == want.model_size == model
            # what the models read of the rules: the rows' axes, and
            # whether the sequence is cut (cp and ep over 2+ shards)
            assert sharding.data_spec(got) == (
                data_axes if len(data_axes) > 1 else data_axes[0],)
            assert got.seq_split == (plan != "tp" and model > 1)


def _reference_tree(arch):
    cfg = jconfigs.get_config(arch)
    mod = (jtransformer if isinstance(cfg, jbase.TransformerConfig)
           else jssm_lm)
    return jax.eval_shape(lambda k: mod.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{prefix}[{k!r}]").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", configs.LM_ARCHS)
def test_infer_param_specs_match_the_reference_at_full_size(arch):
    jtree = _reference_tree(arch)
    cfg = configs.get_config(arch)
    shapes = lm_module(cfg).param_shapes(cfg)
    assert {p: tuple(s.shape) for p, s in _flat(jtree).items()} == {
        p: tuple(s) for p, s in _flat(shapes).items()}
    for mesh_shape in ((16, 16), (2, 4)):
        stand_in = _MeshShape(data=mesh_shape[0], model=mesh_shape[1])
        for plan in PLANS:
            for fsdp in (False, True):
                want = jparam_specs.infer_param_specs(
                    jtree, JPolicy(mesh=stand_in, plan=plan, fsdp=fsdp))
                got = infer_param_specs(shapes, sharding.ShardingPolicy(
                    mesh=stand_in, plan=plan, fsdp=fsdp))
                assert {p: _spec(s) for p, s in _flat(want).items()} == \
                    _flat(got), (mesh_shape, plan, fsdp)


def test_plans_match_the_reference():
    assert configs.PLANS == jconfigs.PLANS
    assert configs._DEFAULT_PLAN == jconfigs._DEFAULT_PLAN
    for arch in configs.ALL_ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k",
                      "other"):
            assert configs.plan_for(arch, shape) == jconfigs.plan_for(
                arch, shape)


@pytest.mark.parametrize("window", WINDOWS)
def test_cp_attention_matches_the_reference(window, inputs, reference):
    mesh = _mesh(("model", 4))
    spec = (None, "model")
    q, k, v = (_blocks(torch.from_numpy(inputs[n]), spec, mesh)
               for n in ("q", "k", "v"))
    outs = spmd.run(mesh, lambda q, k, v: seq_parallel.cp_attention(
        q, k, v, "model", causal=True, window=window, kv_chunk=16), q, k, v)
    _close(_joined(outs, spec, mesh),
           reference.result()[f"cp_attention_{window}"], 2e-5, 2e-5)


def test_cp_ssd_matches_the_reference(inputs, reference):
    """Chunk 8 on each of 4 shards of 16 steps against the reference's
    own cp_ssd (chunk 8) and its unsharded chunked scan at chunk 16
    (``tests/test_multidevice.py:111``'s tolerance); the local scan is
    ``ops.ssd_scan`` (on the CPU its plain sequential version)."""
    mesh = _mesh(("model", 4))
    spec = (None, "model")
    x, dt, Bm, Cm = (_blocks(torch.from_numpy(inputs[n]), spec, mesh)
                     for n in ("x", "dt", "Bm", "Cm"))
    A = torch.from_numpy(inputs["A"])
    outs = spmd.run(mesh, lambda x, dt, Bm, Cm: seq_parallel.cp_ssd(
        x, dt, A, Bm, Cm, "model", chunk=8), x, dt, Bm, Cm)
    got = _joined(outs, spec, mesh)
    ref = reference.result()
    _close(got, ref["cp_ssd"], 1e-4, 1e-4)
    _close(got, ref["ssd_chunked_16"], 1e-4, 1e-4)


def test_sharded_decode_and_cache_update_match_the_reference(inputs,
                                                             reference):
    mesh = _mesh(("model", 4))
    spec = (None, "model")
    kc, vc = (_blocks(torch.from_numpy(inputs[n]), spec, mesh)
              for n in ("kc", "vc"))
    q1 = torch.from_numpy(inputs["q1"])
    new = torch.from_numpy(inputs["new"])
    outs = spmd.run(mesh, lambda k, v: seq_parallel.decode_attention_sharded_kv(
        q1, k, v, CUR, "model"), kc, vc)
    ref = reference.result()
    for out in outs:  # every shard merges to the same output
        _close(out, ref["decode"], 2e-5, 2e-5)
    caches = [c.clone() for c in kc]
    spmd.run(mesh, lambda c: seq_parallel.cache_update_sharded(
        c, new, CUR, "model"), caches)
    assert np.array_equal(_joined(caches, spec, mesh).numpy(), ref["cache"])
    owner = CUR // 16
    for r, (c, before) in enumerate(zip(caches, kc)):
        assert torch.equal(c, before) == (r != owner)


def test_tp_attention_matches_the_reference(inputs, reference):
    """8 query heads and 2 key/value heads over 4 shards: each shard's 2
    query heads read one key/value head."""
    mesh = _mesh(("data", 1), ("model", 4))
    heads = (None, None, "model")
    q = _blocks(torch.from_numpy(inputs["qt"]), heads, mesh)
    k, v = (torch.from_numpy(inputs[n]) for n in ("kt", "vt"))
    outs = spmd.run(mesh, lambda q: seq_parallel.tp_attention(
        q, k, v, "model", causal=True, kv_chunk=16), q)
    _close(_joined(outs, heads, mesh), reference.result()["tp_attention"],
           2e-5, 2e-5)


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_moe_ffn_ep_matches_the_reference(capacity, inputs, reference):
    """Over 2 x 4 shards, against the reference's ``moe_ffn_ep``
    (``tests/test_multidevice.py:247``'s tolerance), and at capacity 8.0
    (no drops) against the unsharded ``moe_ffn`` too; the aux loss the
    reference's (its average of the shards' own)."""
    mesh = _mesh(("data", 2), ("model", 4))
    policy = sharding.ShardingPolicy(mesh, plan="ep")
    tokens = ("data", "model")
    x = _blocks(torch.from_numpy(inputs["moe_x"]), tokens, mesh)
    p = {n: torch.from_numpy(inputs["moe_" + n])
         for n in ("router", "w_gate", "w_up", "w_down")}
    experts = {n: _blocks(p[n], ("model",), mesh)
               for n in ("w_gate", "w_up", "w_down")}
    shards = [dict({n: experts[n][r] for n in experts}, router=p["router"])
              for r in range(mesh.size)]
    outs = spmd.run(mesh, lambda p, x: moe.moe_ffn_ep(
        p, x, num_experts=4, top_k=2, policy=policy,
        capacity_factor=capacity), shards, x)
    ref = reference.result()
    got = _joined([o for o, _ in outs], tokens, mesh)
    _close(got, ref[f"moe_ep_{capacity}"], 2e-4, 2e-4)
    for _, aux in outs:
        _close(aux, ref[f"moe_ep_aux_{capacity}"], 2e-5, 2e-5)
    if capacity == 8.0:
        _close(got, ref["moe_8.0"], 2e-4, 2e-4)
        want, _ = moe.moe_ffn(p, torch.from_numpy(inputs["moe_x"]),
                              num_experts=4, top_k=2, capacity_factor=8.0)
        _close(got, want.numpy(), 2e-4, 2e-4)
