"""Every language-model family of the port against the reference's, on
the CPU: the transformer stacks (dense, MoE, VLM, audio), the Zamba2
hybrid, and their building blocks (RoPE, chunked GQA attention, the MoE
FFN), the configs and parameter counts (their FLOPs:
``tests/test_torch_drivers.py``).

Configs: the nine new configs' SMOKE (``mamba2-370m``'s is held by
``tests/test_torch_mamba2.py``), the reference's ``tests/test_models.py``
transformer CASES (and its vlm-like case), and a hybrid whose layers do
not divide into whole groups and whose attention heads (d_model //
num_heads) are narrower than its SSD heads. Weights come from the
reference's own ``init_params``, with every zero-initialized vector (the
norms, the QKV biases, the SSD block's dt bias, A_log, D, gated-norm
scale and conv bias) replaced by seeded numpy draws so that each is
exercised, and carry across by ``params_from_numpy``; inputs come from
numpy. A config's reference outputs are computed in this process on the
first test that asks for them (``reference``), by two jitted functions
at XLA level 0: one program for the parameters, the forward, the loss
and the prefill, and the reference's serving ``decode_fn`` for 8
teacher-forced decode steps and 4 greedy tokens (its ``generate``'s
argmax loop). The building blocks' references are jitted too (a first
eager call compiles every primitive on its own).

Tolerances, fp32: 1e-4 of the output scale (the two compute the same
sums in other orders, an error near 1e-6 of the scale); greedy tokens
equal. The port's own decode against its own forward: 3e-4 for the
transformers, 5e-4 for the SSM and hybrid, as ``tests/test_models.py``
holds the reference. bf16 attention: 2e-2 of the output scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm_lm as jssm_lm
from repro.models import transformer as jtransformer
from repro.serve import lm as jlm
from repro_torch import configs
from repro_torch.configs.base import HybridConfig, TransformerConfig
from repro_torch.core.sharding import ShardingPolicy
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import frontends, layers, lm_module, moe
from repro_torch.models import ssm_lm, transformer
from repro_torch.serve import lm

REL = 1e-4
B, S, DEC, GEN = 2, 16, 8, 4


def _mk(name, **kw):
    base = dict(name=name, family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97)
    base.update(kw)
    return TransformerConfig(**base)


NEW = [a for a in configs.LM_ARCHS if a != "mamba2-370m"]
CFGS = {f"smoke-{a}": configs.get_smoke_config(a) for a in NEW}
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
# 5 layers in groups of 2 (one left over), attention heads 64 // 8 = 8
# wide against SSD heads of 16, GQA with 4 query heads a KV head
CFGS["hybrid-odd"] = HybridConfig(
    name="hybrid-odd", family="hybrid", num_layers=5, d_model=64,
    ssm_state=16, vocab_size=97, num_heads=8, num_kv_heads=2, d_ff=128,
    attn_every=2, head_dim=16, chunk_size=8)
DECODERS = [c for c, cfg in CFGS.items() if cfg.supports_decode]
# a forward routes B x S tokens through capacity-limited experts and
# drops copies a one-token decode step keeps (the reference too), so
# decode equals the forward only without experts
DENSE_DECODERS = [c for c in DECODERS
                  if not getattr(CFGS[c], "num_experts", 0)]
# the zero-initialized vectors, replaced by draws: (scale, offset)
DRAWS = {"ln1": (0.1, 0.0), "ln2": (0.1, 0.0), "bq": (0.1, 0.0),
         "bk": (0.1, 0.0), "bv": (0.1, 0.0), "final_norm": (0.1, 0.0),
         "block_norms": (0.1, 0.0), "dt_bias": (0.5, 0.0),
         "A_log": (0.5, 0.0), "D": (0.1, 1.0), "norm_scale": (0.1, 0.0),
         "conv_b": (0.1, 0.0)}


def _jcfg(cfg):
    cls = {TransformerConfig: jbase.TransformerConfig,
           HybridConfig: jbase.HybridConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def _jmod(cfg):
    return jtransformer if isinstance(cfg, TransformerConfig) else jssm_lm


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


def _inputs(cfg):
    r = np.random.RandomState(2)
    if getattr(cfg, "embed_inputs", True):
        x = r.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    else:
        x = r.randn(B, S, cfg.d_model).astype(np.float32)
    labels = r.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if isinstance(cfg, TransformerConfig):
        labels[:, :2] = -1  # masked positions
    img = None
    if getattr(cfg, "family", "") == "vlm":
        img = (0.02 * r.randn(B, 4, cfg.d_model)).astype(np.float32)
    return x, labels, img


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def compute_reference(cid):
    """(the parameter tree as numpy, the reference's outputs as numpy):
    one jitted program for the parameters, the forward, the loss and the
    prefill, and the reference's serving ``decode_fn`` jitted once and
    driven from Python for the teacher-forced steps and the greedy loop
    (both caches DEC + GEN long, so it compiles once)."""
    cfg = CFGS[cid]
    jcfg, jm = _jcfg(cfg), _jmod(cfg)
    x, labels, img = _inputs(cfg)
    draws = {p: jnp.asarray(v) for p, v in _draws(cfg).items()}
    decoder = cfg.supports_decode
    if decoder:
        prefill_fn, decode_fn = jlm.make_serve_fns(jcfg)

    def program(key, x, labels, img):
        p = _replace(jm.init_params(key, jcfg), draws)
        out = {"params": p}
        batch = {"tokens": x, "labels": labels}
        if img is not None:
            batch["image_embeds"] = img
        if jm is jtransformer:
            out["logits"], out["aux"] = jm.forward(p, x, jcfg,
                                                   extra_embeds=img)
        else:
            out["logits"] = jm.forward(p, x, jcfg)
        out["loss"] = jm.lm_loss(p, batch, jcfg)
        if decoder:
            out["prefill"], out["prefill_cache"] = prefill_fn(
                p, x[:, :DEC], DEC + GEN)
        return out

    out = _jit(program)(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(labels),
                        None if img is None else jnp.asarray(img))
    if decoder:
        p, step = out["params"], _jit(decode_fn)
        cache, logits = jm.init_cache(jcfg, B, DEC + GEN), []
        for t in range(DEC):
            lg, cache = step(p, cache, jnp.asarray(x[:, t:t + 1]))
            logits.append(lg)
        out["decode"], out["cache"] = jnp.stack(logits), cache
        lg, cache, toks = out["prefill"], out["prefill_cache"], []
        for _ in range(GEN):  # the reference generate's greedy loop
            toks.append(jnp.argmax(lg, axis=-1))
            lg, cache = step(p, cache, toks[-1][:, None])
        out["generate"] = jnp.stack(toks, axis=1)
    out = jax.tree.map(np.asarray, out)
    return out.pop("params"), out


@functools.cache
def reference(cid):
    """``compute_reference(cid)``, computed on its first use in this
    process and kept."""
    return compute_reference(cid)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small
    (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(cid):
    cfg = CFGS[cid]
    return lm_module(cfg).params_from_numpy(reference(cid)[0], cfg,
                                            device="cpu")


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _forward(cid, p, x, img=None):
    cfg = CFGS[cid]
    if isinstance(cfg, TransformerConfig):
        return transformer.forward(p, torch.from_numpy(x), cfg,
                                   extra_embeds=img)
    return ssm_lm.forward(p, torch.from_numpy(x), cfg), None


# ----------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", configs.LM_ARCHS)
def test_configs_and_counts_are_the_references(arch):
    for port, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       jconfigs.get_smoke_config(arch))):
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert arch in configs.ALL_ARCHS and arch in configs.ASSIGNED


def test_registry_and_input_shapes():
    assert configs.LM_ARCHS == jconfigs.ASSIGNED
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    z = configs.get_config("zamba2-1.2b")
    assert (z.num_layers, z.d_model, z.num_heads, z.vocab_size,
            z.num_attn_applications, z.d_model // z.num_heads,
            z.num_ssm_heads) == (38, 2048, 32, 32000, 6, 64, 64)
    assert lm_module(z) is ssm_lm
    assert lm_module(configs.get_config("gemma2-2b")) is transformer
    with pytest.raises(TypeError, match="language-model"):
        lm_module(configs.get_config("cosmoflow-128"))


def test_frontends():
    g = torch.Generator().manual_seed(0)
    a = frontends.synth_audio_embeds(g, 2, 5, 8)
    v = frontends.synth_vision_embeds(g, 2, 8, num_tokens=3)
    assert tuple(a.shape) == frontends.audio_embed_shape(2, 5, 8)
    assert tuple(v.shape) == (2, 3, 8) and a.dtype == torch.float32
    assert frontends.vision_embed_shape(1, 8) == (
        1, frontends.NUM_IMAGE_TOKENS, 8)
    from repro.models import frontends as jfrontends
    assert frontends.NUM_IMAGE_TOKENS == jfrontends.NUM_IMAGE_TOKENS
    assert abs(a.std().item() - 0.02) < 0.01


# ---------------------------------------------------------- building blocks --
@pytest.mark.parametrize("batched", [False, True], ids=["1d", "bs"])
def test_rope_matches_the_reference(batched):
    r = np.random.RandomState(3)
    x = r.randn(2, 7, 3, 16).astype(np.float32)
    pos = (r.randint(0, 50, size=(2, 7)) if batched
           else np.arange(5, 12)).astype(np.int32)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
    want = _jit(functools.partial(jlayers.rope, theta=500.0))(
        jnp.asarray(x), jnp.asarray(pos))
    assert _rel(got, want) <= REL


# (Sq, Skv, H, Hkv, q_pos, kv_pos, causal, window, softcap, kv_chunk,
# dtype); q_pos/kv_pos "r" = arange
ATTN = {
    "gqa-causal": (16, 16, 4, 2, "r", "r", True, 0, 0.0, 1024, "fp32"),
    "gqa-bidirectional": (16, 16, 6, 2, "r", "r", False, 0, 0.0, 1024,
                          "fp32"),
    "window-softcap": (24, 24, 4, 1, "r", "r", True, 5, 20.0, 8, "fp32"),
    "padded-kv-ragged-chunks": (
        3, 20, 4, 2, (17, 18, 19), "pad", True, 0, 0.0, 8, "fp32"),
    "fully-masked-rows": (8, 8, 2, 2, "r", "late", True, 0, 0.0, 4,
                          "fp32"),
    "bf16": (16, 24, 4, 2, "r", "r", True, 6, 30.0, 8, "bf16"),
}


@pytest.mark.parametrize("case", ATTN)
def test_chunked_attention_matches_the_reference(case):
    Sq, Skv, H, Hkv, qp, kvp, causal, window, cap, chunk, prec = ATTN[case]
    r = np.random.RandomState(4)
    q = r.randn(2, Sq, H, 8).astype(np.float32)
    k = r.randn(2, Skv, Hkv, 8).astype(np.float32)
    v = r.randn(2, Skv, Hkv, 8).astype(np.float32)
    q_pos = np.arange(Sq) if qp == "r" else np.asarray(qp)
    kv_pos = {"r": np.arange(Skv),
              # slots 15.. unwritten (a decode cache), Skv = 2.5 chunks
              "pad": np.where(np.arange(Skv) < 15, np.arange(Skv), -1),
              # keys after the first 3 queries: rows 0-2 see nothing
              "late": np.arange(Skv) + 3}[kvp].astype(np.int32)
    q_pos = q_pos.astype(np.int32)
    kw = dict(causal=causal, window=window, attn_softcap=cap,
              kv_chunk=chunk)
    tdt, jdt = ((torch.float32, jnp.float32) if prec == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    got = layers.chunked_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
        **kw)
    want = _jit(functools.partial(jlayers.chunked_attention, **kw))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), q_pos=jnp.asarray(q_pos),
        kv_pos=jnp.asarray(kv_pos))
    assert got.dtype == tdt and tuple(got.shape) == (2, Sq, H, 8)
    assert _rel(got.float(), want.astype(jnp.float32)) <= (
        REL if prec == "fp32" else 2e-2)
    if kvp == "late":
        assert torch.equal(got[:, :3], torch.zeros_like(got[:, :3]))
        assert bool(torch.isfinite(got).all())


def _layer_cases():
    r = np.random.RandomState(6)
    x = r.randn(2, 5, 16).astype(np.float32)
    w1, w2 = r.randn(16, 24).astype(np.float32) / 4, \
        r.randn(16, 24).astype(np.float32) / 4
    w3 = r.randn(24, 16).astype(np.float32) / 5
    s, b = (0.1 * r.randn(16)).astype(np.float32), \
        (0.1 * r.randn(16)).astype(np.float32)
    return {
        "gated_mlp-silu": ("gated_mlp", (x, w1, w2, w3), {}),
        "gated_mlp-gelu": ("gated_mlp", (x, w1, w2, w3),
                           {"activation": "gelu"}),
        "plain_mlp-gelu": ("plain_mlp", (x, w1, w3), {}),
        "plain_mlp-silu": ("plain_mlp", (x, w1, w3), {"activation": "silu"}),
        "layernorm": ("layernorm", (3 * x + 1, s, b), {}),
        "rmsnorm": ("rmsnorm", (3 * x, s), {}),
        "softcap": ("softcap", (10 * x,), {"cap": 5.0}),
    }


@pytest.mark.parametrize("case", list(_layer_cases()))
def test_mlps_norms_and_softcap_match_the_reference(case):
    name, args, kw = _layer_cases()[case]
    got = getattr(layers, name)(*map(torch.from_numpy, args), **kw)
    want = _jit(functools.partial(getattr(jlayers, name), **kw))(
        *map(jnp.asarray, args))
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_the_reference_with_drops(top_k):
    r = np.random.RandomState(5)
    E, D, Fd, cf = 4, 16, 32, 0.5
    x = r.randn(2, 12, D).astype(np.float32)
    p = {"router": r.randn(D, E), "w_gate": r.randn(E, D, Fd) / 4,
         "w_up": r.randn(E, D, Fd) / 4, "w_down": r.randn(E, Fd, D) / 6}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), num_experts=E, top_k=top_k,
                           capacity_factor=cf)
    want, jaux = _jit(functools.partial(
        jmoe.moe_ffn, num_experts=E, top_k=top_k, capacity_factor=cf))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert _rel(got, want) <= REL
    assert abs(aux.item() - float(jaux)) <= REL * max(1.0, float(jaux))
    # copies were dropped: some expert got more than its capacity
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D) @ p["router"]),
                          -1)
    idx = torch.topk(probs, top_k, dim=-1).indices.reshape(-1)
    C = max(int(np.ceil(cf * 24 * top_k / E)), 1)
    assert int(torch.bincount(idx, minlength=E).max()) > C


# ------------------------------------------------------------ the stacks ----
@pytest.mark.parametrize("cid", CFGS)
def test_forward_and_loss_match_the_reference(cid):
    cfg = CFGS[cid]
    _, ref = reference(cid)
    x, labels, img = _inputs(cfg)
    p = _params(cid)
    logits, aux = _forward(cid, p, x,
                           None if img is None else torch.from_numpy(img))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == ref["logits"].shape
    assert _rel(logits, ref["logits"]) <= REL
    if aux is not None:
        assert abs(aux.item() - float(ref["aux"])) <= REL * max(
            1.0, abs(float(ref["aux"])))
    batch = {"tokens": x, "labels": labels}
    if img is not None:
        batch["image_embeds"] = img
    loss = lm_module(cfg).lm_loss(p, batch, cfg)
    assert loss.shape == () and np.isfinite(loss.item())
    assert abs(loss.item() - float(ref["loss"])) <= REL * max(
        1.0, abs(float(ref["loss"])))


def _cache_rel(got, want):
    assert set(got) == set(want)
    assert got["pos"] == int(want["pos"])
    for k in got:
        if k != "pos":
            assert tuple(got[k].shape) == want[k].shape, k
            assert _rel(got[k], want[k]) <= REL, k


@pytest.mark.parametrize("cid", DECODERS)
def test_decode_steps_and_caches_match_the_reference(cid):
    cfg = CFGS[cid]
    _, ref = reference(cid)
    x = torch.from_numpy(_inputs(cfg)[0])
    p, mod = _params(cid), lm_module(cfg)
    cache = mod.init_cache(cfg, B, DEC + GEN, device="cpu")
    for t in range(DEC):
        lg, new = mod.decode_step(p, cache, x[:, t:t + 1], cfg)
        assert _rel(lg, ref["decode"][t]) <= REL, t
        # written in place: the step returns the tensors it was given
        assert all(new[k] is cache[k] for k in cache if k != "pos")
        cache = new
    _cache_rel(cache, ref["cache"])


@pytest.mark.parametrize("cid", DECODERS)
def test_prefill_matches_the_reference(cid):
    cfg = CFGS[cid]
    _, ref = reference(cid)
    x = torch.from_numpy(_inputs(cfg)[0])
    prefill, _ = lm.make_serve_fns(cfg)
    last, cache = prefill(_params(cid), x[:, :DEC], DEC + GEN)
    assert _rel(last, ref["prefill"]) <= REL
    _cache_rel(cache, ref["prefill_cache"])


@pytest.mark.parametrize("cid", DECODERS)
def test_greedy_generate_gives_the_references_tokens(cid):
    cfg = CFGS[cid]
    _, ref = reference(cid)
    x = torch.from_numpy(_inputs(cfg)[0])
    got = lm.generate(_params(cid), x[:, :DEC], cfg, GEN)
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref["generate"])


@pytest.mark.parametrize("cid", DENSE_DECODERS)
def test_decode_matches_forward_in_the_port(cid):
    """Teacher-forced decode against the port's own forward (3e-4 for a
    transformer, 5e-4 for the SSM and hybrid, as ``tests/test_models.py``
    holds the reference), and prefill's last logits against the
    forward's last position."""
    cfg = CFGS[cid]
    tol = 3e-4 if isinstance(cfg, TransformerConfig) else 5e-4
    x = torch.from_numpy(_inputs(cfg)[0])
    p, mod = _params(cid), lm_module(cfg)
    logits = _forward(cid, p, x.numpy())[0]
    cache = mod.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        lg, cache = mod.decode_step(p, cache, x[:, t:t + 1], cfg)
        np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                   rtol=tol, atol=tol)
    prefill, _ = lm.make_serve_fns(cfg)
    last, cache = prefill(p, x, S)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(),
                               rtol=tol, atol=tol)
    assert cache["pos"] == S


def test_encoders_do_not_decode_and_sharding_raises():
    """An encoder has no decode step. A mesh with no policy, or a policy
    with no mesh, is the reference's ``NO_POLICY``: the unsharded forward
    and ``generate``, bit for bit. A process mesh raises naming the next
    slice (the LM over the process mesh)."""
    cfg = CFGS["smoke-hubert-xlarge"]
    p = _params("smoke-hubert-xlarge")
    with pytest.raises(NotImplementedError, match="encoder-only"):
        lm.make_serve_fns(cfg)
    x = _inputs(cfg)[0]
    want, _ = transformer.forward(p, x, cfg)
    assert torch.equal(transformer.forward(p, x, cfg, mesh=object())[0],
                       want)
    dense = CFGS["dense"]
    toks = _inputs(dense)[0]
    assert torch.equal(
        lm.generate(_params("dense"), toks, dense, 2, policy=object()),
        lm.generate(_params("dense"), toks, dense, 2))
    procs = object.__new__(ProcessMesh)
    with pytest.raises(NotImplementedError, match="next slice"):
        transformer.forward(p, x, cfg, mesh=procs)
    with pytest.raises(NotImplementedError, match="next slice"):
        lm.generate(_params("dense"), toks, dense, 2,
                    policy=ShardingPolicy(mesh=procs))
    with pytest.raises(NotImplementedError, match="transformer"):
        ssm_lm.forward(p, _inputs(cfg)[0], cfg)


@pytest.mark.parametrize("cid", ["smoke-zamba2-1.2b", "smoke-phi3.5-moe",
                                 "qwen-like"])
def test_params_from_numpy_rejects_wrong_names_and_shapes(cid):
    cfg = CFGS[cid]
    mod = lm_module(cfg)
    tree = reference(cid)[0]
    sub = "shared_attn" if "zamba2" in cid else (
        "layers" if isinstance(cfg, TransformerConfig) else "blocks")
    leaf = sorted(tree[sub])[-1]
    bad = dict(tree, **{sub: dict(tree[sub])})
    bad[sub][leaf] = bad[sub][leaf][..., :1]
    with pytest.raises(ValueError, match=leaf):
        mod.params_from_numpy(bad, cfg, device="cpu")
    extra = dict(tree, **{sub: dict(tree[sub], stray=tree["final_norm"])})
    with pytest.raises(ValueError, match="stray"):
        mod.params_from_numpy(extra, cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        mod.params_from_numpy(missing, cfg, device="cpu")
    bf = mod.params_from_numpy(tree, cfg, device="cpu",
                               dtype=torch.bfloat16)
    assert bf["final_norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("cid", ["smoke-gemma2-2b", "arctic-like",
                                 "hybrid-odd", "smoke-hubert-xlarge"])
def test_init_params_follows_the_references_law(cid):
    cfg = CFGS[cid]
    mod = lm_module(cfg)
    p = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda a: a.shape, jax.eval_shape(functools.partial(
        _jmod(cfg).init_params, cfg=_jcfg(cfg)), jax.random.PRNGKey(0)))
    got = {k: ({m: tuple(t.shape) for m, t in v.items()}
               if isinstance(v, dict) else tuple(v.shape))
           for k, v in p.items()}
    assert got == want
    if isinstance(cfg, TransformerConfig):
        lay = p["layers"]
        assert torch.equal(lay["ln1"], torch.zeros_like(lay["ln1"]))
        assert abs(lay["wq"].std().item() - cfg.d_model ** -0.5) < 0.02
        assert abs(lay["wo"].std().item() - (
            cfg.num_heads * cfg.resolved_head_dim) ** -0.5) < 0.02
        if cfg.num_experts:
            assert abs(lay["w_down_e"].std().item()
                       - cfg.d_ff ** -0.5) < 0.01
    else:
        sp = p["shared_attn"]
        assert torch.equal(sp["ln2"], torch.zeros_like(sp["ln2"]))
        assert abs(sp["w_down"].std().item() - cfg.d_ff ** -0.5) < 0.01
    x = _inputs(cfg)[0]
    logits = _forward(cid, p, x)[0]
    assert bool(torch.isfinite(logits).all())
