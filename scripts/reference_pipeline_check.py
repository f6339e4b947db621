#!/usr/bin/env python3
"""Why the JAX package's two failing pipeline tests fail, on the CPU.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
        JAX_PLATFORMS=cpu python scripts/reference_pipeline_check.py

Runs the set-ups of ``tests/test_pipeline.py`` step by step (the JAX
package only; nothing of the port):

* ``test_pipeline_parity_cosmoflow``: cosmoflow-512 SMOKE, gb 8, Adam
  1e-3; the unpipelined step over ``data=4`` against the pipelined step
  cut at (2,), M = 1, 2 data shards a group. Prints both losses at steps
  1-3, and after step 1 every parameter element that differs by more
  than 1e-4, with both updates and the unpipelined gradient there (the
  ``grad_comm`` probe) as a share of its leaf's max-abs.
* ``test_micro_backward_fires_bucketed_reductions``: the traced jaxpr of
  a non-last node's backward, its psum count against the group's bucket
  count, and where the psums stand among the conv and dot equations.
* the pipelined U-Net (``test_pipeline_bitwise_unet``'s set-up at
  M = 2): each parameter's largest update after one step (its down
  nodes' parameters of every group but the deepest do not move).

One JSON object a line.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro import configs
from repro.core import compat, grad_comm
from repro.core import plan as plan_lib
from repro.launch import mesh as mesh_lib
from repro.models import cosmoflow
from repro.optim.adam import Adam
from repro.train import train_step as ts


def parity():
    cfg = configs.get_smoke_config("cosmoflow-512")
    gb = 8
    params = cosmoflow.init_params(jax.random.PRNGKey(0), cfg)
    kx, ky = jax.random.split(jax.random.PRNGKey(1))
    x = np.asarray(jax.random.normal(
        kx, (gb,) + (cfg.input_width,) * 3 + (cfg.in_channels,)),
        np.float32)
    y = np.asarray(jax.random.normal(ky, (gb, cfg.out_dim)), np.float32)
    opt = Adam(lambda s: 1e-3)
    mesh = mesh_lib.make_local_mesh(model=1, data=4)
    kw = dict(spatial_axes=(None, None, None), data_axes=("data",),
              global_batch=gb, grad_comm="overlap")
    step_ref = ts.make_convnet_train_step(cfg, mesh, opt, **kw)
    probe = ts.make_convnet_phase_probes(cfg, mesh, opt, **kw)["grad_comm"]
    p_ref = jax.tree.map(jnp.copy, params)
    o_ref = ts.make_convnet_opt_state(cfg, opt, params, grad_comm="overlap")
    _, grads = probe(jax.tree.map(jnp.copy, params),
                     ts.make_convnet_opt_state(cfg, opt, params,
                                               grad_comm="overlap"),
                     x, y, 0)
    plan = plan_lib.pipelined_convnet_plan(
        cfg, boundaries=(2,), micro_batches=1, schedule="1f1b",
        data_degrees=(2,))
    meshes = mesh_lib.make_pipeline_meshes(plan)
    step = ts.make_pipeline_train_step(cfg, meshes, opt, plan=plan,
                                       global_batch=gb, grad_comm="overlap")
    p = jax.tree.map(jnp.copy, params)
    o = ts.make_pipeline_opt_state(cfg, opt, p, plan=plan, meshes=meshes)
    for s in range(3):
        p_ref, o_ref, l_ref = step_ref(p_ref, o_ref, x, y, s)
        p, o, l = step(p, o, x, y, s)
        print(json.dumps({"test": "parity", "step": s + 1,
                          "unpipelined_loss": float(l_ref),
                          "pipelined_loss": float(l),
                          "difference": abs(float(l) - float(l_ref))}))
        if s == 0:
            for k in sorted(params):
                a, b = np.asarray(p_ref[k]), np.asarray(p[k])
                bad = np.argwhere(np.abs(a - b) > 1e-4)
                g = np.asarray(grads[k])
                scale = float(np.max(np.abs(g)))
                for idx in map(tuple, bad):
                    p0 = float(np.asarray(params[k])[idx])
                    print(json.dumps({
                        "test": "parity", "after_step": 1, "leaf": k,
                        "element": list(map(int, idx)),
                        "unpipelined_update": float(a[idx]) - p0,
                        "pipelined_update": float(b[idx]) - p0,
                        "unpipelined_grad": float(g[idx]),
                        "grad_share_of_max_abs": abs(float(g[idx])) / scale,
                        "leaf_elements": int(g.size)}))
                rest = np.abs(a - b)
                print(json.dumps({"test": "parity", "after_step": 1,
                                  "leaf": k, "elements_over_1e-4":
                                  int((rest > 1e-4).sum()),
                                  "max_difference": float(rest.max())}))


def jaxpr_order():
    cfg = dataclasses.replace(configs.get_smoke_config("cosmoflow-512"),
                              batchnorm=False)
    w = cfg.input_width
    plan = plan_lib.pipelined_convnet_plan(cfg, boundaries=(2,),
                                           micro_batches=4,
                                           data_degrees=(2,))
    a, b = plan.group_layer_ranges()[0]
    params = jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda k: cosmoflow.init_params(k, cfg),
                       jax.random.PRNGKey(0)))
    gparams = ts.pipeline_group_params(cfg, plan, params)[0]
    buckets = grad_comm.make_plan(gparams)
    mesh = compat.make_mesh((2,), ("data",))
    h = jnp.zeros((2, w, w, w, cfg.in_channels))

    def bwd(p, h):
        def f(p_, h_):
            return cosmoflow.forward_range(p_, h_, cfg, a, b,
                                           bn_axes=("data",), train=True,
                                           grad_axes=("data",))
        out, vjp = jax.vjp(f, p, h)
        return vjp(jnp.ones_like(out))

    f = compat.shard_map(bwd, mesh=mesh, in_specs=(P(), P("data")),
                         out_specs=(P(), P("data")))

    def find(jaxpr):
        if any(e.primitive.name == "psum" for e in jaxpr.eqns):
            return jaxpr
        for e in jaxpr.eqns:
            for v in e.params.values():
                for item in (v if isinstance(v, (list, tuple)) else [v]):
                    item = getattr(item, "jaxpr", item)
                    if hasattr(item, "eqns"):
                        r = find(item)
                        if r is not None:
                            return r
        return None

    names = [e.primitive.name for e in find(
        jax.make_jaxpr(f)(gparams, h).jaxpr).eqns]
    compute = [i for i, n in enumerate(names)
               if n in ("conv_general_dilated", "dot_general")]
    psums = [i for i, n in enumerate(names) if n == "psum"]
    print(json.dumps({"test": "jaxpr_order", "psums": len(psums),
                      "buckets": buckets.num_buckets,
                      "psum_positions": psums,
                      "compute_positions": compute,
                      "psums_before_a_compute": sum(
                          1 for q in psums if any(c > q for c in compute)),
                      "equations": len(names)}))


def unet_updates():
    """One pipelined step of the U-Net SMOKE (gb 8, cut at (1,), M = 2,
    2 data shards a group): each parameter's largest update."""
    from repro.models import unet3d

    cfg = configs.get_smoke_config("unet3d-256")
    gb = 8
    params = unet3d.init_params(jax.random.PRNGKey(0), cfg)
    kx, ky = jax.random.split(jax.random.PRNGKey(1))
    x = np.asarray(jax.random.normal(
        kx, (gb,) + (cfg.input_width,) * 3 + (cfg.in_channels,)),
        np.float32)
    y = np.asarray(jax.random.randint(
        ky, (gb,) + (cfg.input_width,) * 3, 0, cfg.out_dim), np.int32)
    opt = Adam(lambda s: 1e-3)
    plan = plan_lib.pipelined_convnet_plan(cfg, boundaries=(1,),
                                           micro_batches=2,
                                           data_degrees=(2,))
    meshes = mesh_lib.make_pipeline_meshes(plan)
    step = ts.make_pipeline_train_step(cfg, meshes, opt, plan=plan,
                                       global_batch=gb, grad_comm="overlap",
                                       donate=False)
    p = jax.tree.map(jnp.copy, params)
    o = ts.make_pipeline_opt_state(cfg, opt, p, plan=plan, meshes=meshes)
    p2, _, loss = step(p, o, x, y, 0)
    print(json.dumps({"test": "unet_updates", "loss": float(loss),
                      "max_update": {k: float(np.max(np.abs(
                          np.asarray(p2[k]) - np.asarray(params[k]))))
                          for k in sorted(params)}}))


if __name__ == "__main__":
    parity()
    jaxpr_order()
    unet_updates()
