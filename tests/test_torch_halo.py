"""The port's halo pack/unpack, halo exchange and spatial conv against the
reference's, on the CPU.

* ``pack`` / ``unpack``: the port's plain versions (which its wrappers
  run on CPU tensors) against ``repro.kernels.halo_pack.ref`` and the
  Pallas kernels in interpret mode — exact, since both are copies.
* ``halo_exchange`` and ``start_halo_exchange`` + ``unpack_halo`` over
  S in {1, 2, 4} shards, k in {3, 5}, stride in {1, 2}: the port's
  ``core.spmd.run`` over ``["cpu"] * S`` against the reference under
  ``shard_map`` on S forced host devices — exact.
* ``conv3d`` with overlap on and off against the reference's under
  ``shard_map`` — 1e-5 abs, the reference's own overlap/blocking
  contract (DESIGN.md §3). The reference convs run through XLA here:
  its Pallas conv in interpret mode would take minutes at these 16
  cases, and ``test_torch_kernels.py`` holds it against the port's.

The reference runs once per module in a subprocess with 4 forced host
devices (the ``multidevice`` fixture); inputs are made there with numpy
from a seed and written, with its outputs, to an ``.npz``.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.halo_pack import kernel as jkernel
from repro.kernels.halo_pack import ref as jref
from repro_torch.core import halo, spmd
from repro_torch.core.spatial_conv import SpatialPartitioning, conv3d
from repro_torch.kernels.halo_pack import ops as pack_ops
from repro_torch.kernels.halo_pack import ref as pack_ref
from repro_torch.launch.mesh import Mesh

HALO_CASES = [(s, k, st) for s in (1, 2, 4) for k in (3, 5) for st in (1, 2)]
CONV_CASES = [(s, k, st, ov) for s in (2, 4) for k in (3, 5) for st in (1, 2)
              for ov in (True, False)]

REFERENCE = r'''
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import compat, halo
from repro.core.spatial_conv import SpatialPartitioning, conv3d

out = {}
part = SpatialPartitioning(("model", None, None))
for S in (1, 2, 4):
    mesh = compat.make_mesh((S,), ("model",))
    for k in (3, 5):
        for s in (1, 2):
            lo, hi = halo.conv_halo_widths(k, s)
            r = np.random.RandomState(100 * S + 10 * k + s)
            x = r.randn(2, 4 * S, 3, 5, 3).astype(np.float32)
            tag = f"{S}_{k}_{s}"
            out["halo_x_" + tag] = x
            blocking = jax.jit(compat.shard_map(
                lambda x: halo.halo_exchange(x, "model", 1, lo, hi),
                mesh=mesh, in_specs=P(None, "model"),
                out_specs=P(None, "model")))
            packed = jax.jit(compat.shard_map(
                lambda x: halo.unpack_halo(
                    x, halo.start_halo_exchange(x, "model", 1, lo, hi,
                                                use_pallas=True),
                    1, use_pallas=True),
                mesh=mesh, in_specs=P(None, "model"),
                out_specs=P(None, "model")))
            out["halo_block_" + tag] = np.asarray(blocking(x))
            out["halo_packed_" + tag] = np.asarray(packed(x))
            if S == 1:
                continue
            x = r.randn(2, 16, 6, 6, 3).astype(np.float32)
            w = (r.randn(k, k, k, 3, 4) * 0.2).astype(np.float32)
            out["conv_x_" + tag], out["conv_w_" + tag] = x, w
            for ov in (True, False):
                f = jax.jit(compat.shard_map(
                    lambda x, w, _ov=ov: conv3d(x, w, part, stride=s,
                                                overlap=_ov),
                    mesh=mesh, in_specs=(P(None, "model"), P()),
                    out_specs=P(None, "model")))
                out[f"conv_{tag}_{int(ov)}"] = np.asarray(f(x, w))
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    path = tmp_path_factory.mktemp("halo") / "reference.npz"
    multidevice(f"OUT = {str(path)!r}\n" + REFERENCE, devices=4)
    return dict(np.load(path))


def _run(S, fn, xs):
    """fn on each shard of an S-way ``model`` mesh on the CPU; the
    shards' outputs concatenated along depth."""
    mesh = Mesh([("model", S)], ["cpu"] * S)
    return torch.cat(spmd.run(mesh, fn, xs), 1).numpy()


def _shards(x, S):
    return [torch.from_numpy(np.ascontiguousarray(c))
            for c in np.split(x, S, axis=1)]


# ------------------------------------------------------- pack / unpack ----
PACK_SHAPES = [(2, 6, 3, 4, 5), (1, 4, 8, 8, 16), (3, 5, 1, 7, 3)]
WIDTHS = [(1, 1), (0, 1), (1, 0), (2, 2), (1, 2)]


@pytest.mark.parametrize("shape", PACK_SHAPES)
@pytest.mark.parametrize("lo,hi", WIDTHS)
def test_pack_matches_reference_exactly(shape, lo, hi):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = pack_ops.pack(torch.from_numpy(x), lo, hi)
    want_prev, want_next = jref.pack(jnp.asarray(x), 1, lo, hi)
    kern_prev, kern_next = jkernel.pack_depth(jnp.asarray(x), lo, hi,
                                              interpret=True)
    for part, want, kern in ((got.to_next, want_next, kern_next),
                             (got.to_prev, want_prev, kern_prev)):
        if want is None:
            assert part is None and kern is None
            continue
        np.testing.assert_array_equal(part.numpy(), np.asarray(want))
        np.testing.assert_array_equal(part.numpy(), np.asarray(kern))
    # one buffer, [to_next | to_prev], each part a contiguous view of it
    assert got.buf.dim() == 1 and got.buf.numel() == (
        shape[0] * (lo + hi) * np.prod(shape[2:]))
    views = [p for p in (got.to_next, got.to_prev) if p is not None]
    np.testing.assert_array_equal(
        got.buf.numpy(), np.concatenate([p.numpy().ravel() for p in views]))
    assert all(p.is_contiguous() and p.data_ptr() >= got.buf.data_ptr()
               for p in views)


@pytest.mark.parametrize("shape", PACK_SHAPES)
@pytest.mark.parametrize("lo,hi", WIDTHS)
def test_unpack_matches_reference_exactly(shape, lo, hi):
    r = np.random.RandomState(1)
    x = r.randn(*shape).astype(np.float32)
    n, _, h, w, c = shape
    lo_b = r.randn(n, lo, h, w, c).astype(np.float32) if lo else None
    hi_b = r.randn(n, hi, h, w, c).astype(np.float32) if hi else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = pack_ops.unpack(t(x), t(lo_b), t(hi_b)).numpy()
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    np.testing.assert_array_equal(got, np.asarray(jref.unpack(
        j(x), j(lo_b), j(hi_b), 1)))
    if lo and hi:  # the Pallas kernel takes both buffers
        np.testing.assert_array_equal(got, np.asarray(jkernel.unpack_depth(
            j(x), j(lo_b), j(hi_b), interpret=True)))


def test_pack_unpack_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 4, 3, 3, 2)
    with pytest.raises(ValueError, match="outside"):
        pack_ops.pack(x, 5, 1)
    with pytest.raises(ValueError, match="floating"):
        pack_ops.pack(torch.zeros(2, 4, 3, 3, 2, dtype=torch.int32), 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        pack_ops.unpack(x, torch.zeros(2, 1, 3, 4, 2), None)
    with pytest.raises(ValueError, match="float64"):
        pack_ops.unpack(x, torch.zeros(2, 1, 3, 3, 2, dtype=torch.float64),
                        None)
    faces = pack_ref.faces(torch.arange(2 * 3 * 9 * 2.0), (2, 4, 3, 3, 2),
                           1, 2)
    assert faces.to_next.shape == (2, 1, 3, 3, 2)
    assert faces.to_prev.shape == (2, 2, 3, 3, 2)


# ------------------------------------------------------- halo exchange ----
@pytest.mark.parametrize("S,k,s", HALO_CASES)
def test_halo_exchange_matches_shard_map_exactly(reference, S, k, s):
    tag = f"{S}_{k}_{s}"
    lo, hi = halo.conv_halo_widths(k, s)
    xs = _shards(reference["halo_x_" + tag], S)
    blocking = _run(S, lambda x: halo.halo_exchange(x, "model", 1, lo, hi),
                    xs)
    np.testing.assert_array_equal(blocking, reference["halo_block_" + tag])
    packed = _run(S, lambda x: halo.unpack_halo(
        x, halo.start_halo_exchange(x, "model", 1, lo, hi), 1), xs)
    np.testing.assert_array_equal(packed, reference["halo_packed_" + tag])


def test_start_halo_exchange_sends_the_fewest_ppermutes(monkeypatch):
    """One swap on a 2-way axis, one shift each way beyond, and the
    counts on the tracer."""
    from repro_torch.obs import trace as trace_lib

    calls = []
    real = spmd.Group.ppermute_start

    def counting(self, t, perm):
        calls.append(tuple(perm))
        return real(self, t, perm)

    monkeypatch.setattr(spmd.Group, "ppermute_start", counting)
    tracer = trace_lib.enable()
    try:
        for S, want in ((2, 1), (4, 2)):
            calls.clear()
            x = np.random.RandomState(S).randn(1, 3 * S, 2, 2, 2)
            _run(S, lambda x: halo.unpack_halo(
                x, halo.start_halo_exchange(x, "model", 1, 1, 1), 1),
                _shards(x.astype(np.float32), S))
            assert len(calls) == S * want, (S, calls)
    finally:
        trace_lib.disable(tracer)
    counters = tracer.metrics.counters()
    assert counters["halo.exchanges"].value == 2 + 4
    assert counters["halo.ppermutes"].value == 2 * 1 + 4 * 2


@pytest.mark.parametrize("S", (2, 4))
def test_ppermute_hands_over_the_senders_tensor_on_one_device(S):
    """On one device a shard receives its neighbour's tensor itself, not
    a copy; unpaired destinations get zeros."""
    def fn(x):
        g = spmd.axis("model")
        got = g.ppermute(x, [(i, i + 1) for i in range(S - 1)])
        return got.data_ptr(), got.clone()

    xs = [torch.full((3,), float(i)) for i in range(S)]
    out = spmd.run(Mesh([("model", S)], ["cpu"] * S), fn, xs)
    assert torch.equal(out[0][1], torch.zeros(3))
    for r in range(1, S):
        assert out[r][0] == xs[r - 1].data_ptr()
        assert torch.equal(out[r][1], xs[r - 1])


@pytest.mark.parametrize("S", (2, 4))
def test_overlapped_conv_issues_the_interior_before_reading_the_slabs(
        monkeypatch, S):
    """The interior conv is issued before the shard first reads a
    received slab (where its stream waits for the neighbour), and the
    boundary convs after."""
    from repro_torch.core import spatial_conv
    from repro_torch.kernels.conv3d import ops as conv_ops

    events = threading.local()
    real_conv, real_wait = conv_ops.conv3d_valid, spmd.Received.wait

    def conv(x, *a, **kw):
        events.log.append(("conv", x.shape[1]))
        return real_conv(x, *a, **kw)

    def wait(self):
        events.log.append(("wait",))
        return real_wait(self)

    monkeypatch.setattr(conv_ops, "conv3d_valid", conv)
    monkeypatch.setattr(spmd.Received, "wait", wait)
    w = torch.randn(3, 3, 3, 2, 2)
    part = SpatialPartitioning(("model", None, None))

    def fn(x):
        events.log = []
        spatial_conv.conv3d(x, w, part, overlap=True)
        return events.log

    xs = [torch.randn(1, 6, 4, 4, 2) for _ in range(S)]
    for log in spmd.run(Mesh([("model", S)], ["cpu"] * S), fn, xs):
        # the interior conv reads the whole block (depth 6); each
        # boundary piece reads 1 slab row and 2 local rows
        assert log[0] == ("conv", 6), log
        assert [e for e in log if e[0] == "conv"] == [
            ("conv", 6), ("conv", 3), ("conv", 3)], log
        assert ("wait",) in log, log


# ---------------------------------------------------------- spatial conv ----
@pytest.mark.parametrize("S,k,s,ov", CONV_CASES)
def test_conv3d_matches_shard_map(reference, S, k, s, ov):
    tag = f"{S}_{k}_{s}"
    w = torch.from_numpy(reference["conv_w_" + tag])
    part = SpatialPartitioning(("model", None, None))
    got = _run(S, lambda x: conv3d(x, w, part, stride=s, overlap=ov),
               _shards(reference["conv_x_" + tag], S))
    np.testing.assert_allclose(got, reference[f"conv_{tag}_{int(ov)}"],
                               rtol=0, atol=1e-5)


def test_a_failing_shard_aborts_the_others():
    """A shard that raises while its peers wait in a collective makes
    ``run`` raise its error; no shard thread is left behind."""
    def fn(x):
        g = spmd.axis("model")
        if g.index == 1:
            raise RuntimeError("shard 1 failed")
        return g.psum(x)

    mesh = Mesh([("model", 4)], ["cpu"] * 4)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        spmd.run(mesh, fn, [torch.ones(2)] * 4)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-shard-")]
    # the mesh is usable again, and psum adds in rank order
    out = spmd.run(mesh, lambda x: spmd.axis("model").psum(x),
                   [torch.full((2,), float(i)) for i in range(4)])
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in out)


def test_collectives_hold_under_fast_thread_switching():
    """8 shards (more than this host's cores may be) swap, sum and
    gather 40 times with the interpreter switching threads every
    microsecond: every result is the exact one, in rank order."""
    import sys

    S = 8

    def fn(x):
        g = spmd.axis("model")
        for step in range(40):
            right = g.ppermute(x + step, [(i, (i + 1) % S) for i in range(S)])
            assert torch.equal(right, torch.full((3,), float(
                (g.index - 1) % S + step)))
            assert torch.equal(g.psum(x), torch.full((3,), 28.0))
            assert torch.equal(g.all_gather(x, 0),
                               torch.arange(S).float().repeat_interleave(3))
        return g.index

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = spmd.run(Mesh([("model", S)], ["cpu"] * S), fn,
                       [torch.full((3,), float(i)) for i in range(S)])
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(S))
