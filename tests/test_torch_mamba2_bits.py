"""The Mamba2 serving path keeps its bits now that it is differentiable.

The causal conv's ``out=`` bias add now runs inside an autograd
``Function`` (``mamba2._BiasRowMajor``), and the chunked scan no
longer runs its decay weights through an in-place ``masked_fill_`` /
``exp_`` / ``mul_`` chain. ``_old_causal_conv1d`` and
``_old_ssd_chunked`` below are the earlier formulations (the scan
without its ``init_state``, which these calls do not pass): the
new ones must give the same bits, in the block, the LM forward and the
scan (fp32, fp64 and bf16 inputs), and still agree with the reference
to 1e-4 of the output scale (``tests/test_torch_mamba2.py``'s
tolerance). The conv's output must stay row-major, so that the scan
kernel's x, B and C views of it are the layouts ``ops.kernel_strides``
takes.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as jmamba2
from repro.models import ssm_lm as jssm_lm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import mamba2, ssm_lm

REL = 1e-4
THREE = SSMConfig(name="ssm", family="ssm", num_layers=3, d_model=64,
                  ssm_state=16, vocab_size=97, head_dim=16, chunk_size=8)
CFGS = {"mamba2-370m-smoke": get_smoke_config("mamba2-370m"), "ssm3": THREE}


def _old_causal_conv1d(x, w, b):
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=C)
    return torch.add(out.transpose(1, 2), b,
                     out=out.new_empty(out.shape[0], out.shape[2], C))


def _old_ssd_chunked(x, dt, A, Bm, Cm, *, chunk=256):
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc = L // Q
    ct = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(ct).reshape(Bb, nc, Q, H, P)
    dtc = dt.to(ct).reshape(Bb, nc, Q, H)
    Bc = Bm.to(ct).reshape(Bb, nc, Q, N)
    Cc = Cm.to(ct).reshape(Bb, nc, Q, N)
    sig = torch.cumsum(dtc * A.to(ct), dim=2)
    sig_last = sig[:, :, -1, :]
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    w = sig[:, :, :, None, :] - sig[:, :, None, :, :]
    w.masked_fill_(upper[None, None, :, :, None], float("-inf")).exp_()
    w.mul_(torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[..., None])
    w.mul_(dtc[:, :, None, :, :])
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xc)
    decay_states = torch.exp(sig_last[:, :, None, :] - sig) * dtc
    states = torch.einsum("bckhp,bckn->bchpn",
                          xc * decay_states[..., None], Bc)
    chunk_decay = torch.exp(sig_last)
    s = torch.zeros((Bb, H, P, N), dtype=ct, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    y += torch.einsum("bcqn,bchpn->bcqhp", Cc,
                      torch.stack(s_in, dim=1)) * torch.exp(sig)[..., None]
    y = y.reshape(Bb, L, H, P)
    chunk_off = torch.cumsum(sig_last, dim=1) - sig_last
    cumdecay = (sig + chunk_off[:, :, None, :]).reshape(Bb, L, H)
    return y.to(x.dtype), s, cumdecay


def _weights(cfg):
    """The reference's initial parameters as numpy, the zero and constant
    vectors replaced by seeded draws."""
    p = jax.tree.map(np.asarray, jssm_lm.init_params(
        jax.random.PRNGKey(0), JSSMConfig(**dataclasses.asdict(cfg))))
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


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _scan_inputs(L, dtype, seed=0):
    r = np.random.RandomState(seed)
    H, P, N = 3, 8, 16
    arrs = [r.randn(2, L, H, P), 0.5 * r.rand(2, L, H) + 0.05,
            -0.5 - r.rand(H), r.randn(2, L, N), r.randn(2, L, N)]
    arrs = [a.astype(np.float64 if dtype == torch.float64 else np.float32)
            for a in arrs]
    ts = [torch.from_numpy(a) for a in arrs]
    return arrs, [t if i == 2 else t.to(dtype) for i, t in enumerate(ts)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("L,chunk", [(48, 16), (48, 48), (32, 8)])
def test_ssd_chunked_keeps_its_bits(dtype, L, chunk):
    arrs, ts = _scan_inputs(L, dtype)
    y, ex = mamba2.ssd_chunked(*ts, chunk=chunk)
    oy, os_, ocum = _old_ssd_chunked(*ts, chunk=chunk)
    assert torch.equal(y, oy) and torch.equal(ex.final_state, os_)
    assert torch.equal(ex.cumdecay, ocum)
    if dtype != torch.bfloat16:
        jy, jex = jax.jit(jmamba2.ssd_chunked, static_argnames=("chunk",))(
            *(jnp.asarray(a, jnp.float32) for a in arrs), chunk=chunk)
        assert _rel(y, jy) <= REL and _rel(ex.final_state,
                                           jex.final_state) <= REL


@pytest.mark.parametrize("name", list(CFGS))
def test_block_and_forward_keep_their_bits(name):
    """The block and the LM forward with the earlier conv against the
    present one (bitwise), both against the reference (1e-4)."""
    cfg = CFGS[name]
    w = _weights(cfg)
    p = ssm_lm.params_from_numpy(w, cfg, device="cpu")
    r = np.random.RandomState(2)
    toks = r.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    h = r.randn(2, 16, cfg.d_model).astype(np.float32)
    bp = {k: v[0] for k, v in p["blocks"].items()}
    kw = dict(num_heads=cfg.num_ssm_heads, head_dim=cfg.head_dim,
              ssm_state=cfg.ssm_state, chunk=cfg.chunk_size)

    def run():
        return (mamba2.block_forward(bp, torch.from_numpy(h), **kw),
                ssm_lm.forward(p, toks, cfg))

    new = run()
    with mock.patch.object(mamba2, "_causal_conv1d", _old_causal_conv1d):
        old = run()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    jcfg = JSSMConfig(**dataclasses.asdict(cfg))
    jbp = {k: jnp.asarray(v[0]) for k, v in w["blocks"].items()}
    jblock = jax.jit(lambda p, h: jmamba2.block_forward(p, h, **kw))(
        jbp, jnp.asarray(h))
    jlogits = jax.jit(lambda p, t: jssm_lm.forward(p, t, jcfg))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(toks))
    assert _rel(new[0], jblock) <= REL and _rel(new[1], jlogits) <= REL


def test_conv_output_stays_row_major():
    """The conv's output is row-major like the earlier ``out=`` buffer,
    and its x, B and C column views are what the scan kernel reads in
    place (``kernel_strides``: x's rows and Bm/Cm at one stride)."""
    r = np.random.RandomState(3)
    H, P, N = 4, 8, 16
    C = H * P + 2 * N
    x = torch.from_numpy(r.randn(2, 12, C).astype(np.float32))
    w = torch.from_numpy(r.randn(4, C).astype(np.float32))
    b = torch.from_numpy(r.randn(C).astype(np.float32))
    out = mamba2._causal_conv1d(x, w, b)
    old = _old_causal_conv1d(x, w, b)
    assert out.is_contiguous() and out.stride() == old.stride()
    assert torch.equal(out, old)
    xs, Bm, Cm = torch.split(F.silu(out), [H * P, N, N], dim=-1)
    strides = ssd_ops.kernel_strides(xs.reshape(2, 12, H, P), Bm, Cm)
    assert strides == (12 * C, C, 12 * C, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bias_add_gradient_is_the_plain_adds(dtype):
    """``_BiasRowMajor``'s gradients are autograd's of the plain
    ``out.transpose(1, 2) + b``, bit for bit, for the conv's output and
    the bias."""
    r = np.random.RandomState(5)
    out = torch.from_numpy(r.randn(2, 6, 12).astype(np.float32)).to(dtype)
    b = torch.from_numpy(r.randn(6).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(r.randn(2, 12, 6).astype(np.float32)).to(dtype)
    leaves = [out.clone().requires_grad_(), b.clone().requires_grad_()]
    y = mamba2._BiasRowMajor.apply(*leaves)
    got = torch.autograd.grad(y, leaves, gy)
    plain = [out.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(plain[0].transpose(1, 2) + plain[1], plain,
                               gy)
    assert y.is_contiguous()
    assert all(a.dtype == w.dtype and torch.equal(a, w)
               for a, w in zip(got, want))
