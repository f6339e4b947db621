"""The port's optimizers, mixed-precision wrapper and step guard against
the reference's (``repro.optim.adam``, ``repro.core.precision``,
``repro.train.guard``), on the same numpy parameters and gradients.

Tolerance: 1e-6 of each leaf's scale over 5 steps (fp32; the two
frameworks may round ``b ** t`` and the square root differently in the
last place). The fp16 loss-scale and skip sequence, and every guard
decision, must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprecision
from repro.optim import adam as jadam
from repro.train import guard as jguard
from repro_torch.core import precision
from repro_torch.optim import adam
from repro_torch.train import guard

SHAPES = {"conv0_w": (3, 3, 3, 2, 4), "bn0_scale": (4,), "fc0_w": (32, 8),
          "fc0_b": (8,)}


def _tree(seed, scale=1.0):
    r = np.random.RandomState(seed)
    return {k: (scale * r.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rel=1e-6):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.all(np.isfinite(g)), k
        err = np.max(np.abs(g - w))
        assert err <= rel * max(1e-3, np.max(np.abs(w))), (k, err)


def _schedules(name):
    return {"constant": (jadam.constant(1e-3), adam.constant(1e-3)),
            "linear_decay": (jadam.linear_decay(1e-2, 4),
                             adam.linear_decay(1e-2, 4)),
            "warmup_cosine": (jadam.warmup_cosine(1e-2, 2, 5),
                              adam.warmup_cosine(1e-2, 2, 5))}[name]


@pytest.mark.parametrize("schedule,clip,decay", [
    ("constant", 0.0, 0.0), ("linear_decay", 0.0, 0.0),
    ("warmup_cosine", 0.0, 0.0), ("linear_decay", 0.5, 0.0),
    ("constant", 0.5, 1e-2)])
def test_adam_matches_reference_over_five_steps(schedule, clip, decay):
    jlr, tlr = _schedules(schedule)
    jopt = jadam.Adam(lr=jlr, grad_clip=clip, weight_decay=decay)
    topt = adam.Adam(lr=tlr, grad_clip=clip, weight_decay=decay)
    p0 = _tree(0)
    jp, tp = _j(p0), _t(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.3)
        jp, js = jopt.update(_j(g), js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
    # the update is functional: the initial tensors are untouched
    assert all(np.array_equal(_t(p0)[k].numpy(), p0[k]) for k in p0)


@pytest.mark.parametrize("name", ["constant", "linear_decay",
                                  "warmup_cosine"])
def test_schedules_match_reference(name):
    jlr, tlr = _schedules(name)
    for s in range(8):
        want = float(jlr(jnp.asarray(s, jnp.int32)))
        got = tlr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-3)


def test_sgd_and_global_norm_match_reference():
    jopt = jadam.SGD(lr=jadam.constant(1e-2))
    topt = adam.SGD(lr=adam.constant(1e-2))
    jp, tp = _j(_tree(0)), _t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.v is None
    for step in range(3):
        g = _tree(20 + step)
        jp, js = jopt.update(_j(g), js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        _close(tp, jp)
    g = _tree(5)
    want = float(jadam.global_norm(_j(g)))
    assert abs(float(adam.global_norm(_t(g))) - want) <= 1e-6 * want


def test_fp16_scale_and_skip_sequence_matches_reference():
    """Dynamic loss scaling with a growth interval of 2 over 7 steps,
    with injected overflows at steps 2 and 5 (an inf gradient leaf and a
    NaN one): each step's loss scale, good-step count, step count and
    parameters equal the reference's, and a skipped step holds the
    parameters bitwise."""
    jpol = dataclasses.replace(jprecision.FP16, growth_interval=2)
    tpol = dataclasses.replace(precision.FP16, growth_interval=2)
    jopt = jprecision.wrap_optimizer(jadam.Adam(lr=jadam.constant(1e-3),
                                                grad_clip=1.0), jpol)
    topt = precision.wrap_optimizer(adam.Adam(lr=adam.constant(1e-3),
                                              grad_clip=1.0), tpol)
    assert isinstance(topt, precision.MixedPrecision)
    assert precision.wrap_optimizer(topt, tpol) is topt
    assert precision.wrap_optimizer(topt.inner, "bf16") is topt.inner
    jp, tp = _j(_tree(0)), _t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    seen = []
    for step in range(7):
        g = _tree(30 + step, scale=float(ts.loss_scale) * 1e-2)
        if step == 2:
            g["fc0_w"][0, 0] = np.inf
        if step == 5:
            g["bn0_scale"][1] = np.nan
        before = {k: v.clone() for k, v in tp.items()}
        jp, js = jopt.update(_j(g), js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        assert float(ts.loss_scale) == float(js.loss_scale)
        assert int(ts.good_steps) == int(js.good_steps)
        assert int(ts.inner.step) == int(js.inner.step)
        _close(tp, jp)
        if step in (2, 5):
            assert all(torch.equal(tp[k], before[k]) for k in tp)
        seen.append(float(ts.loss_scale))
    assert seen == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 16,
                    2.0 ** 15, 2.0 ** 15]
    assert int(ts.inner.step) == 5
    assert float(precision.current_scale(ts, tpol)) == seen[-1]
    assert float(precision.current_scale(None, precision.FP32)) == 1.0


def test_guard_matches_reference():
    g = _tree(1)
    bad = dict(g, fc0_b=np.full(8, np.nan, np.float32))
    for grads, loss in ((g, 1.0), (bad, 1.0), (g, np.inf)):
        want = bool(jguard.agreed_finite(jnp.asarray(loss, jnp.float32),
                                         _j(grads), ()))
        got = guard.agreed_finite(torch.tensor(loss, dtype=torch.float32),
                                  _t(grads))
        assert bool(got) == want
        assert bool(precision.all_finite(_t(grads))) == bool(
            jprecision.all_finite(_j(grads)))
    old, new = _t(_tree(2)), _t(_tree(3))
    for flag in (True, False):
        sel = guard.tree_select(torch.tensor(flag), new, old)
        assert all(torch.equal(sel[k], (new if flag else old)[k])
                   for k in sel)
    poisoned = guard.poison_unless(torch.tensor(False), _t(g))
    assert all(torch.isnan(v).all() for v in poisoned.values())
    kept = guard.poison_unless(torch.tensor(True), _t(g))
    assert all(torch.equal(kept[k], _t(g)[k]) for k in g)
