"""The port's input pipeline (``repro_torch.data``) against the
reference's ``repro.data``, on the CPU.

* synthetic datasets: the same bytes for the same seed;
* store files: written by either package, read by the other;
* the epoch schedule: equal to the reference's for several seeds and
  epochs;
* on the one-device mesh, ``load_batch``'s x and y and the ``IOStats``
  counters equal the reference's ``SpatialParallelLoader``'s (vector
  targets and voxel labels, with and without the halo margin);
* on ``["cpu"] * n`` meshes, each rank reads exactly its hyperslab (plus
  the margin) and the global batch is the store's; the owner-rank
  redistribution of the reference's multi-device test;
* the prefetch contracts of ``tests/test_io_pipeline.py``: bitwise equal
  to the synchronous loader, fallback on unpredicted ids, occupancy,
  close drains, a worker fault surfaces, a transient fault is absorbed;
* ``Session.make_loader`` and its telemetry keys, ``loader_retries``
  counted, prefetched training bitwise equal to synchronous training.
"""
import os

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat
from repro.data import pipeline as jpipeline
from repro.data import store as jstore
from repro.data import synthetic as jsynthetic
from repro_torch.api import RunConfig, compile
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.core import faults
from repro_torch.core import plan as plan_lib
from repro_torch.core.spatial_conv import SpatialPartitioning
from repro_torch.data import pipeline, prefetch, store, synthetic
from repro_torch.data.store import StoreReadError
from repro_torch.launch.mesh import Mesh

W = 16


def _dataset(root, n=8, w=W, channels=2, seed=0, segmentation=False):
    if segmentation:
        cubes, labels = synthetic.make_segmentation_dataset(
            n, w, channels=channels, seed=seed)
        store.write_dataset(str(root), cubes, labels=labels)
    else:
        cubes, targets = synthetic.make_cosmology_dataset(
            n, w, channels=channels, seed=seed)
        store.write_dataset(str(root), cubes, targets)
    return str(root)


def _stage(D=1, S=1):
    """The entry stage (and plan) of a D x S mesh splitting depth: the
    U-Net's fixed plan, one stage at any width."""
    plan = plan_lib.legacy_convnet_plan(
        unet_cfg.SMOKE, SpatialPartitioning(("model", None, None)),
        (S, 1, 1), data_degrees=(D,))
    return plan.stages[0], plan


def _loader(root, D=1, S=1, *, seed=0, cache=True, pf=0, global_batch=4,
            halo=0):
    stage, plan = _stage(D, S)
    mesh = Mesh(plan.mesh_axes, ["cpu"] * (D * S))
    ld = pipeline.SpatialParallelLoader(
        store.HyperslabStore(root), mesh, stage, global_batch=global_batch,
        seed=seed, cache=cache, halo_voxels=halo)
    return prefetch.PrefetchLoader(ld, depth=pf) if pf else ld


def _ref_loader(root, *, seed=0, cache=True, halo=0, voxel=False):
    return jpipeline.SpatialParallelLoader(
        jstore.HyperslabStore(root), compat.make_mesh((1, 1),
                                                      ("data", "model")),
        P("data", "model", None, None, None), global_batch=4, seed=seed,
        cache=cache, halo_voxels=halo,
        label_spec=P("data", "model", None, None) if voxel else None)


# ------------------------------------------------------ synthetic ----
def test_synthetic_datasets_equal_the_reference_bitwise():
    cubes, targets = synthetic.make_cosmology_dataset(3, W, channels=2,
                                                      seed=5)
    jcubes, jtargets = jsynthetic.make_cosmology_dataset(3, W, channels=2,
                                                         seed=5)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(cubes, jcubes))
    assert targets.tobytes() == jtargets.tobytes()
    sub, st = synthetic.split_into_subvolumes(cubes, targets, 2)
    jsub, jst = jsynthetic.split_into_subvolumes(jcubes, jtargets, 2)
    assert len(sub) == 24
    assert all(np.array_equal(a, b) for a, b in zip(sub, jsub))
    assert st.tobytes() == jst.tobytes()
    vols, labels = synthetic.make_segmentation_dataset(2, W, channels=1,
                                                       seed=4)
    jvols, jlabels = jsynthetic.make_segmentation_dataset(2, W, channels=1,
                                                          seed=4)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(vols, jvols))
    assert all(a.tobytes() == b.tobytes() for a, b in zip(labels, jlabels))


# ---------------------------------------------------------- store ----
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_files_are_read_by_the_other_package(tmp_path, writer):
    cubes, targets = synthetic.make_cosmology_dataset(3, W, channels=2,
                                                      seed=1)
    vols, labels = synthetic.make_segmentation_dataset(2, W, seed=2)
    write = (store if writer == "port" else jstore).write_dataset
    write(str(tmp_path / "c"), cubes, targets)
    write(str(tmp_path / "s"), vols, labels=labels)
    read = (jstore if writer == "port" else store).HyperslabStore
    c, s = read(str(tmp_path / "c")), read(str(tmp_path / "s"))
    assert (c.num_samples, c.sample_shape, c.target_dim, c.label_kind) == (
        3, (W, W, W, 2), 4, "vector")
    assert (s.num_samples, s.label_kind) == (2, "voxel")
    slab = (slice(4, 8), slice(0, W), slice(2, 9), slice(None))
    for i in range(3):
        assert np.array_equal(c.read_hyperslab(i, slab), cubes[i][slab])
        assert np.array_equal(c.target(i), targets[i])
    assert np.array_equal(s.read_hyperslab(1, (slice(None),) * 3, "y"),
                          labels[1])
    # a read touches the slab's bytes only, and is counted
    assert c.bytes_read == 3 * 4 * W * 7 * 2 * 4 and c.reads == 3


def test_store_retries_transients_and_names_the_file(tmp_path):
    root = _dataset(tmp_path, n=2)
    st = store.HyperslabStore(root)
    with faults.active(faults.FaultSpec("loader.read", at_calls=(0, 1),
                                        max_fires=2)):
        st.read_full(0)
    assert st.retries == 2
    with faults.active(faults.FaultSpec("loader.read", probability=1.0)):
        with pytest.raises(StoreReadError, match="x_000001.npy"):
            st.read_full(1)


# ------------------------------------------------------- schedule ----
def test_schedule_equals_the_reference(tmp_path):
    root = _dataset(tmp_path)
    for seed in (0, 3, 7, 123):
        ld, ref = _loader(root, seed=seed), _ref_loader(root, seed=seed)
        for epoch in (0, 1, 5):
            assert np.array_equal(ld.schedule_for_epoch(epoch),
                                  ref.schedule_for_epoch(epoch))
        for _ in range(2):
            assert np.array_equal(ld.epoch_schedule(), ref.epoch_schedule())


# --------------------------------------------- one-device batches ----
def _counters(stats):
    return (stats.pfs_bytes, stats.cache_bytes_local,
            stats.cache_bytes_redistributed, stats.label_fetches)


@pytest.mark.parametrize("voxel,halo,cache", [(False, 0, True),
                                              (False, 2, False),
                                              (True, 0, True),
                                              (True, 1, True)])
def test_one_device_batches_and_counters_equal_the_reference(
        tmp_path, voxel, halo, cache):
    root = _dataset(tmp_path, segmentation=voxel, channels=1 if voxel else 2)
    ld = _loader(root, seed=2, cache=cache, halo=halo)
    ref = _ref_loader(root, seed=2, cache=cache, halo=halo, voxel=voxel)
    for _ in range(2):  # the second epoch is served from the cache
        order, jorder = ld.epoch_schedule(), ref.epoch_schedule()
        for lo in range(0, 8, 4):
            x, y = ld.load_batch(order[lo:lo + 4])
            jx, jy = ref.load_batch(jorder[lo:lo + 4])
            assert x.dtype == torch.float32 and x.device.type == "cpu"
            assert np.array_equal(x.numpy(), np.asarray(jx))
            assert np.array_equal(y.numpy(), np.asarray(jy))
            assert _counters(ld.stats) == _counters(ref.stats)
    assert ld.stats.rank_pfs_bytes == {0: ld.stats.pfs_bytes}


# ---------------------------------------------------- mesh ranks ----
@pytest.mark.parametrize("D,S", [(1, 2), (1, 4), (2, 2), (2, 1)])
@pytest.mark.parametrize("halo", [0, 2])
def test_each_rank_reads_its_hyperslab(tmp_path, D, S, halo):
    root = _dataset(tmp_path, n=4)
    ld = _loader(root, D, S, cache=False, halo=halo)
    ids = np.array([3, 0, 2, 1])
    x, y = ld.load_batch(ids)
    full = store.HyperslabStore(root)
    assert np.array_equal(x.numpy(), np.stack([full.read_full(int(i))
                                               for i in ids]))
    assert np.array_equal(y.numpy(), np.stack([full.target(int(i))
                                               for i in ids]))
    row = W * W * 2 * 4  # one depth row of one sample, bytes
    d_loc = W // S
    for r in range(D * S):
        d = r % S  # the rank's depth coordinate
        lo = min(halo, d * d_loc)
        hi = min(halo, W - (d + 1) * d_loc)
        want = (4 // D) * (d_loc + lo + hi) * row
        assert ld.stats.rank_pfs_bytes[r] == want, (r, ld.stats)
    assert ld.stats.pfs_bytes == sum(ld.stats.rank_pfs_bytes.values())


def test_voxel_labels_split_like_the_input(tmp_path):
    root = _dataset(tmp_path, n=4, segmentation=True, channels=1)
    ld = _loader(root, 2, 2)
    x, y = ld.load_batch(np.arange(4))
    full = store.HyperslabStore(root)
    assert np.array_equal(y.numpy(), np.stack(
        [full.read_hyperslab(i, (slice(None),) * 3, "y") for i in range(4)]))
    assert np.array_equal(x.numpy(), np.stack([full.read_full(i)
                                               for i in range(4)]))


def test_owner_rank_redistribution_on_a_two_rank_mesh(tmp_path):
    """The reference's ``test_owner_rank_redistribution_multidevice``:
    with 2-way data parallelism and shuffled epochs, samples move between
    ranks, so the cache's hits split into local and redistributed
    bytes."""
    root = _dataset(tmp_path)
    ld = _loader(root, 2, 1)
    for _ in range(3):
        order = ld.epoch_schedule()
        for lo in range(0, 8, 4):
            ld.load_batch(order[lo:lo + 4])
    assert ld.stats.cache_bytes_redistributed > 0, ld.stats
    assert ld.stats.cache_bytes_local > 0, ld.stats
    assert 0 < ld.stats.cache_hit_ratio() < 1


def test_single_rank_cache_hits_all_local(tmp_path):
    root = _dataset(tmp_path)
    ld = _loader(root)
    for _ in range(2):
        order = ld.epoch_schedule()
        for lo in range(0, 8, 4):
            ld.load_batch(order[lo:lo + 4])
    assert ld.stats.cache_bytes_local > 0
    assert ld.stats.cache_bytes_redistributed == 0


def test_vector_label_cache(tmp_path):
    root = _dataset(tmp_path)
    ld = _loader(root)
    order = ld.epoch_schedule()
    ld.load_batch(order[:4])
    assert ld.stats.label_fetches == 4
    ld.load_batch(order[:4])  # a repeated batch: served by the label cache
    assert ld.stats.label_fetches == 4
    ld.load_batch(order[4:8])
    assert ld.stats.label_fetches == 8


def test_vector_label_cache_holds_one_epoch_of_batches(tmp_path):
    """Shuffled epochs rarely repeat a batch, so the cache keeps at most
    one epoch's batches (the newest) instead of growing every step."""
    root = _dataset(tmp_path)
    ld = _loader(root)  # 8 samples, batches of 4: two a epoch
    seen = []
    for _ in range(4):
        order = ld.epoch_schedule()
        for lo in range(0, 8, 4):
            seen.append(tuple(int(i) for i in order[lo:lo + 4]))
            ld.load_batch(order[lo:lo + 4])
            assert len(ld._label_cache) <= 2
    assert list(ld._label_cache) == seen[-2:]
    n0 = ld.stats.label_fetches
    ld.load_batch(np.asarray(seen[-1]))  # the newest batch: still a hit
    assert ld.stats.label_fetches == n0


def test_sample_parallel_loader_reads_whole_samples(tmp_path):
    root = _dataset(tmp_path, n=4)
    stage, plan = _stage(1, 2)
    ld = pipeline.SampleParallelLoader(
        store.HyperslabStore(root), Mesh(plan.mesh_axes, ["cpu"] * 2), stage,
        global_batch=4)
    ids = np.arange(4)
    x, _ = ld.load_batch(ids)
    spatial = _loader(root, 1, 2)
    assert np.array_equal(x.numpy(), spatial.load_batch(ids)[0].numpy())
    assert ld.stats.rank_pfs_bytes == {0: 4 * W ** 3 * 2 * 4}
    assert ld.stats.rank_pfs_bytes[0] == 2 * spatial.stats.rank_pfs_bytes[0]
    n0 = ld.stats.label_fetches
    ld.load_batch(ids)
    assert ld.stats.label_fetches == n0


def test_halo_voxels_read_the_margin_and_serve_the_exact_slab(tmp_path):
    root = _dataset(tmp_path)
    plain = _loader(root, 1, 2, cache=False)
    halo = _loader(root, 1, 2, cache=False, halo=2)
    ids = np.arange(4)
    assert np.array_equal(plain.load_batch(ids)[0].numpy(),
                          halo.load_batch(ids)[0].numpy())
    assert halo.stats.pfs_bytes > plain.stats.pfs_bytes
    wide = halo._expand((slice(4, 8), slice(0, W), slice(0, W)), (W,) * 3)
    assert (wide[0].start, wide[0].stop) == (2, 10)
    assert (wide[1].start, wide[1].stop) == (0, W)  # clamped


# ------------------------------------------------------- prefetch ----
def test_schedule_identical_sync_and_prefetch(tmp_path):
    root = _dataset(tmp_path)
    sync, pf = _loader(root, seed=3), _loader(root, seed=3, pf=2)
    for _ in range(2):
        assert np.array_equal(sync.epoch_schedule(), pf.epoch_schedule())
    pf.close()


@pytest.mark.parametrize("D,S", [(1, 1), (1, 2)])
def test_prefetch_batches_bitwise_equal_sync(tmp_path, D, S):
    root = _dataset(tmp_path)
    sync, pf = _loader(root, D, S, seed=5), _loader(root, D, S, seed=5,
                                                    pf=2)
    for _ in range(2):
        o1, o2 = sync.epoch_schedule(), pf.epoch_schedule()
        for lo in range(0, 8, 4):
            xs, ys = sync.load_batch(o1[lo:lo + 4])
            xp, yp = pf.load_batch(o2[lo:lo + 4])
            assert np.array_equal(xs.numpy(), xp.numpy())
            assert np.array_equal(ys.numpy(), yp.numpy())
    assert pf.queue_hits > 0
    pf.close()


def test_prefetch_fallback_on_unpredicted_ids(tmp_path):
    root = _dataset(tmp_path)
    sync, pf = _loader(root, seed=1), _loader(root, seed=1, pf=2)
    ids = np.array([6, 0, 3, 5])
    assert np.array_equal(sync.load_batch(ids)[0].numpy(),
                          pf.load_batch(ids)[0].numpy())
    assert pf.sync_fallbacks == 1
    order = pf.epoch_schedule()
    pf.load_batch(order[:4])
    pf.load_batch(order[4:8])
    assert pf.queue_hits >= 1
    pf.close()


def test_prefetch_queue_occupancy_and_telemetry(tmp_path):
    root = _dataset(tmp_path)
    pf = _loader(root, pf=2)
    order = pf.epoch_schedule()
    for lo in range(0, 8, 4):
        pf.load_batch(order[lo:lo + 4])
    assert 0.0 < pf.queue_occupancy() <= 2.0
    assert pf.stall_s >= 0.0
    assert pf.served == 2
    pf.close()


def test_prefetch_close_drains_and_raises(tmp_path):
    root = _dataset(tmp_path)
    pf = _loader(root, pf=2)
    order = pf.epoch_schedule()
    pf.load_batch(order[:4])
    pf.close()
    pf.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pf.load_batch(order[:4])


def test_worker_thread_fault_surfaces_on_consumer(tmp_path):
    root = _dataset(tmp_path)
    pf = _loader(root, pf=2, cache=False)
    try:
        with faults.active(faults.FaultSpec("loader.read",
                                            probability=1.0)):
            order = pf.epoch_schedule()
            with pytest.raises(StoreReadError):
                pf.load_batch(order[:4])
    finally:
        pf.close()


def test_worker_thread_transient_fault_absorbed(tmp_path):
    root = _dataset(tmp_path)
    sync = _loader(root, seed=2, cache=False)
    ref, _ = sync.load_batch(sync.epoch_schedule()[:4])
    pf = _loader(root, seed=2, pf=2, cache=False)
    try:
        with faults.active(faults.FaultSpec("loader.read", at_calls=(0, 1),
                                            max_fires=2)):
            x, _ = pf.load_batch(pf.epoch_schedule()[:4])
        assert np.array_equal(ref.numpy(), x.numpy())
        assert pf.store.retries == 2
    finally:
        pf.close()


# ------------------------------------------------------- session ----
def _session(root=None, **kw):
    return compile(RunConfig(model="cosmoflow-128", smoke=True,
                             global_batch=2, data_dir=root, **kw),
                   device="cpu")


def test_session_loader_prefetch_default_and_telemetry(tmp_path):
    sess = _session(_dataset(tmp_path, n=4, w=32))
    try:
        ld = sess.make_loader()
        assert isinstance(ld, prefetch.PrefetchLoader)  # config default 2
        order = ld.epoch_schedule()
        x, y = ld.load_batch(order[:2])
        assert np.isfinite(float(sess.step(x, y)))
        tele = sess.telemetry()
        # the batch's two volumes, and those of the next the worker may
        # have read ahead
        volume = 32 ** 3 * 2 * 4
        assert tele["io_pfs_bytes"] % volume == 0
        assert 2 * volume <= tele["io_pfs_bytes"] <= 4 * volume
        assert "io_stall_s" in tele and "io_queue_occupancy" in tele
        assert 0.0 <= tele["io_cache_hit_ratio"] <= 1.0
        assert tele["loader_retries"] == 0.0
        sess2 = _session(str(tmp_path), prefetch=0)
        ld2 = sess2.make_loader(cache=False)
        assert isinstance(ld2, pipeline.SpatialParallelLoader)
        with faults.active(faults.FaultSpec("loader.read", at_calls=(0,),
                                            max_fires=1)):
            ld2.load_batch(ld2.epoch_schedule()[:2])
        t2 = sess2.telemetry()
        assert "io_queue_occupancy" not in t2 and t2["io_pfs_bytes"] > 0
        assert t2["loader_retries"] == 1.0  # a transient, absorbed
        sess2.close()
    finally:
        sess.close()


def test_session_writes_a_synthetic_dataset_it_removes_on_close():
    sess = compile(RunConfig(model="unet3d-256", smoke=True, global_batch=2,
                             spatial=2), devices=["cpu"] * 2)
    ld = sess.make_loader(num_samples=4, seed=3, prefetch=0)
    root = ld.store.root
    order = ld.epoch_schedule()
    x, y = ld.load_batch(order[:2])
    assert x.shape == (2, 16, 16, 16, 1) and y.shape == (2, 16, 16, 16)
    vols, labels = synthetic.make_segmentation_dataset(
        4, 16, num_classes=3, channels=1, seed=3)
    assert np.array_equal(x.numpy(), np.stack([vols[i] for i in order[:2]]))
    assert np.array_equal(y.numpy(), np.stack([labels[i]
                                               for i in order[:2]]))
    # each rank: its depth half of two volumes (fp32) and of their labels
    # (int32)
    half = 2 * 8 * 16 * 16 * 4
    assert ld.stats.rank_pfs_bytes == {0: 2 * half, 1: 2 * half}
    assert np.isfinite(float(sess.step(x, y)))
    sess.close()
    assert not os.path.exists(root)


def test_prefetched_training_is_bitwise_the_synchronous_training():
    losses = {}
    for depth in (0, 2):
        sess = compile(RunConfig(model="cosmoflow-128", smoke=True,
                                 global_batch=2, spatial=2, prefetch=depth),
                       devices=["cpu"] * 2)
        ld = sess.make_loader(num_samples=4, seed=1)
        order = ld.epoch_schedule()
        losses[depth] = [float(sess.step(*ld.load_batch(order[i:i + 2])))
                         for i in (0, 2)]
        sess.close()
    assert losses[0] == losses[2]
