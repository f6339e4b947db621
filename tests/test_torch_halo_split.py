"""The halo copy engine's work split, on the CPU.

``kernels/halo_pack/ops.py`` lays a pack or an unpack out as parts (one
run a sample each, ``parts``) and cuts the runs into chunks over one
flat index (``split``); the CUDA kernel receives both as they are. These
tests hold the host's side: for any (N, D, row, lo, hi, element size)
the parts, copied run by run, give ``ref.pack`` / ``ref.unpack``'s bytes
and write every output byte once; the chunks cover every run and none
reaches past its run's end; the vectors a thread follow the rule; a
width of 0 gives its face no chunk; more runs than 65,535 are taken. The
kernel itself is held bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.halo_pack import ops, ref

SMS = 132
DTYPES = {2: torch.float16, 4: torch.float32, 8: torch.float64}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().ravel()


def _inputs(kind, n, d, row, elem, lo, hi, seed):
    if kind == "pack":
        lo, hi = min(lo, d), min(hi, d)
    dt = DTYPES[elem]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d, row, 1, 1), generator=g).to(dt)
    bufs = [torch.randn((n, k, row, 1, 1), generator=g).to(dt) if k
            else None for k in (lo, hi)]
    return x, bufs, lo, hi


@settings(deadline=None, max_examples=60)
@given(kind=st.sampled_from(["pack", "unpack"]), n=st.integers(1, 3),
       d=st.integers(1, 6), row=st.integers(1, 1500),
       elem=st.sampled_from([2, 4, 8]), lo=st.integers(0, 6),
       hi=st.integers(0, 6), seed=st.integers(0, 2 ** 16))
def test_parts_copied_run_by_run_give_the_plain_bytes(kind, n, d, row,
                                                      elem, lo, hi, seed):
    x, bufs, lo, hi = _inputs(kind, n, d, row, elem, lo, hi, seed)
    ps = ops.parts(kind, n, d, row * elem, lo, hi)
    srcs = ([_bytes(x)] * 2 if kind == "pack" else
            [None if b is None else _bytes(b) for b in (bufs[0], x,
                                                         bufs[1])])
    want = _bytes(ref.pack(x, lo, hi).buf if kind == "pack"
                  else ref.unpack(x, *bufs))
    out = np.zeros_like(want)
    seen = np.zeros(want.size, np.int32)
    for p, part in enumerate(ps):
        for s in range(n if part.bytes else 0):
            a = part.src_offset + s * part.src_stride
            b = part.dst_offset + s * part.dst_stride
            assert a + part.bytes <= srcs[p].size
            out[b:b + part.bytes] = srcs[p][a:a + part.bytes]
            seen[b:b + part.bytes] += 1
    assert (seen == 1).all(), "an output byte written twice or never"
    np.testing.assert_array_equal(out, want)


@settings(deadline=None, max_examples=200)
@given(kind=st.sampled_from(["pack", "unpack"]), n=st.integers(1, 40),
       d=st.integers(1, 64), row=st.integers(1, 1 << 20),
       elem=st.sampled_from([2, 4, 8]), lo=st.integers(0, 3),
       hi=st.integers(0, 3), sms=st.sampled_from([1, 16, 132]))
def test_chunks_cover_every_run_and_follow_the_vector_rule(
        kind, n, d, row, elem, lo, hi, sms):
    if kind == "pack":
        lo, hi = min(lo, d), min(hi, d)
    ps = ops.parts(kind, n, d, row * elem, lo, hi)
    sp = ops.split(ps, n, sms)
    assert sp.chunk == sp.vectors * ops.REG_THREADS * 16
    assert sp.chunk % 16 == 0 and sp.total == n * sum(sp.chunks)
    for part, k in zip(ps, sp.chunks):
        # k chunks from offset 0 cover the run, the last one not empty
        assert (k - 1) * sp.chunk < part.bytes <= k * sp.chunk or (
            k == part.bytes == 0)
    work = n * sum(p.bytes for p in ps)
    if work >= ops.REG_STREAM_BYTES:
        assert sp.vectors == 1
    else:
        wider = [v for v in ops.REG_VECTORS if v > sp.vectors]
        # every wider count leaves an SM without a block
        for v in wider:
            c = v * ops.REG_THREADS * 16
            assert n * sum(-(-p.bytes // c) for p in ps) < sms
        assert sp.total >= sms or sp.vectors == ops.REG_VECTORS[-1]


@pytest.mark.parametrize("work,vectors", [
    (1 << 30, 1), (64 << 20, 1), ((64 << 20) - 16, 4), (132 * 4 * 4096, 4),
    (131 * 4 * 4096, 2), (132 * 2 * 4096, 2), (132 * 4096 - 16, 1),
    (16, 1)])
def test_register_path_takes_the_widest_vectors_that_fill_every_sm(
        work, vectors):
    """The widest vectors whose chunks give every SM a block, and one a
    thread once a launch streams past the L2."""
    ps = (ops.Part(0, work, 0, work, work),)
    sp = ops.split(ps, 1, SMS)
    assert sp.vectors == vectors
    assert sp.total == -(-work // sp.chunk)


def test_a_patch_of_the_vectors_is_seen_by_the_launch_cache():
    """``_launch`` keys on the constants ``split`` reads, so a test that
    holds one vector count gets it on a shape seen before."""
    args = ("unpack", 2, 6, 512, 1, 1, SMS)
    built = ops._launch(*args, ops.REG_VECTORS, ops.REG_STREAM_BYTES)[0]
    assert ops._launch(*args, ops.REG_VECTORS,
                       ops.REG_STREAM_BYTES)[0] is built
    for v in (4, 2, 1):
        with mock.patch.multiple(ops, REG_VECTORS=(v,),
                                 REG_STREAM_BYTES=1 << 62):
            sp, geom = ops._launch(*args, ops.REG_VECTORS,
                                   ops.REG_STREAM_BYTES)
        assert sp.vectors == v
        assert list(geom) == [f for p in ops.parts(*args[:6]) for f in p]


def test_samples_are_not_capped_by_the_grid():
    """More runs than 65,535 (a grid's y-dimension cap, where samples
    once rode): the flat index runs on, one block a chunk."""
    n = 30_000
    sp = ops.split(ops.parts("unpack", n, 3, 16, 1, 1), n, SMS)
    assert sp.total == 3 * n > 65_535


def test_a_width_of_zero_gives_its_face_no_chunk():
    for kind, lo, hi in (("pack", 0, 2), ("pack", 2, 0), ("unpack", 0, 2),
                         ("unpack", 2, 0)):
        ps = ops.parts(kind, 2, 6, 512, lo, hi)
        sp = ops.split(ps, 2, SMS)
        empty = [i for i, p in enumerate(ps) if p.bytes == 0]
        assert empty and all(sp.chunks[i] == 0 for i in empty)
    sp = ops.split(ops.parts("pack", 2, 6, 512, 0, 0), 2, SMS)
    assert sp.total == 0
