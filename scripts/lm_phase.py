#!/usr/bin/env python3
"""``chip_smoke.py``'s language-model work alone, after its card and
build phases: phase 11 (the SSD scan kernel against its plain version,
at both LM layer shapes among the others), phase 13b (every LM family at
its published width: zamba2-1.2b scored, decoded and held against the
plain scan and fp64; the transformers scored and held against their fp64
forwards, qwen1.5-0.5b and gemma2-2b decoded against their forwards)
with its launch count, and phase 14's ssd_scan timings at zamba2-1.2b's
layer shape.

    python3 scripts/lm_phase.py [--skip-ssd]
    python3 scripts/lm_phase.py --decode-only [--src DIR]
    python3 scripts/lm_phase.py --train-only [--train-arch ARCH ...]
    python3 scripts/lm_phase.py --serve-only [--src DIR]
    python3 scripts/lm_phase.py --sharded-only [--sharded-run TAG ...]

``--train-only`` runs phase 13c alone instead (after the build): LM
training (``chip_smoke.LM_TRAIN``, or those of its archs given by
``--train-arch``; step 1 against fp64, remat against none, the timed
steps, the drivers) with its launch count, then the SSD backward's time
at both layer shapes.

``--sharded-only`` runs phase 13d alone instead (after the build): the
sharded language models over an in-process mesh on the card
(``chip_smoke.LM_SHARDED``, or those of its runs given by
``--sharded-run``; step 1 against the unsharded step, the timed steps,
serving, the launcher) with its launch count, and prints the phase's
seconds.

``--serve-only`` times the SSM models' scoring forward alone instead
(after the build): ``lm_loss`` of mamba2-370m (phase 12's weights and
tokens) and zamba2-1.2b (phase 13b's, under ``inference_mode`` as
there) at each of ``chip_smoke.SCORE_HYBRID``'s runs, on the host clock
(median of SERVE_REPS calls after a warm-up), with the ssd_scan launches
a forward; with ``--src`` it times another commit's port beside this
one.

``--decode-only`` times decode alone instead: qwen1.5-0.5b's and
gemma2-2b's decode step (batch 1, from a prefill of phase 13b's tokens
less 16) on the host clock (median of 3 passes of DECODE_STEPS steps) and
under ``torch.profiler`` (one pass: the card's busy time and what it
spent it on), without building the kernels. ``--src DIR`` imports the
port from DIR (another commit's ``src``, unpacked with ``git archive``)
to time it beside this one.

Writes the report to ``chiprun_out/lm_phase.json`` (``--out`` to name
another). Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ARGS.add_argument("--skip-ssd", action="store_true",
                  help="phase 13b alone (no phase 11, no timings)")
ARGS.add_argument("--decode-only", action="store_true",
                  help="decode timings alone (no phase 11 or 13b)")
ARGS.add_argument("--train-only", action="store_true",
                  help="phase 13c alone (LM training), then the SSD "
                       "backward's time")
ARGS.add_argument("--serve-only", action="store_true",
                  help="the SSM models' lm_loss timings alone")
ARGS.add_argument("--sharded-only", action="store_true",
                  help="phase 13d alone (the sharded language models)")
ARGS.add_argument("--sharded-run", action="append", default=None,
                  help="with --sharded-only: only this tag of "
                       "chip_smoke.LM_SHARDED (repeatable)")
ARGS.add_argument("--train-arch", action="append", default=None,
                  help="with --train-only: train only this arch of "
                       "chip_smoke.LM_TRAIN (repeatable)")
ARGS.add_argument("--src", default=os.path.join(HERE, "src"),
                  help="the port's source directory")
ARGS.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                "lm_phase.json"))
args = ARGS.parse_args()
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.abspath(args.src))
import chip_smoke as cs  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.core import flags, tree  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bn_act import ops as bn_ops  # noqa: E402
from repro_torch.kernels.conv3d import ops as conv_ops  # noqa: E402
from repro_torch.kernels.halo_pack import ops as pack_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import frontends, mamba2, ssm_lm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim.adam import Adam, warmup_cosine  # noqa: E402
from repro_torch.serve import lm  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

DECODE_STEPS = 4
SERVE_REPS = 5
# (arch, the weights' generator seed and device, under inference_mode):
# phase 12's mamba2-370m and phase 13b's zamba2-1.2b
SERVE_ARCHS = (("mamba2-370m", 0, "cpu", False),
               ("zamba2-1.2b", 10, "cuda", True))


def serve_timing(k) -> dict:
    """``lm_loss`` of each SERVE_ARCHS model at each SCORE_HYBRID run:
    host ms (median of SERVE_REPS after a warm-up) and the ssd_scan
    launches a forward (the model's Mamba2 blocks, checked)."""
    rows = {}
    for arch, seed, gen_dev, inference in SERVE_ARCHS:
        cfg = configs.get_config(arch)
        ctx = (cs.torch.inference_mode() if inference
               else cs.contextlib.nullcontext())
        with ctx:
            p32 = k.ssm_lm.init_params(
                cfg, cs.torch.Generator(device=gen_dev).manual_seed(seed),
                device="cuda")
            params = {"fp32": p32, "bf16": cs.to_dtype(p32,
                                                       cs.torch.bfloat16)}
            for batch, seqlen, prec in cs.SCORE_HYBRID:
                tag = f"{arch}/{prec}/{batch}x{seqlen}"
                data = cs.lm_batch(cfg, batch, seqlen, seed=7)
                p = params[prec]
                c0 = cs.counts(k)["ssd_scan"]
                k.ssm_lm.lm_loss(p, data, cfg)
                launched = cs.counts(k)["ssd_scan"] - c0
                cs.check(launched == cfg.num_layers,
                         f"{tag}: {launched} ssd_scan launches a forward")
                ms = cs.host_ms(lambda: k.ssm_lm.lm_loss(p, data, cfg),
                                SERVE_REPS)
                rows[tag] = {"ms": ms, "ssd_launches_per_forward": launched}
                cs.log("serve", f"{tag}: lm_loss {ms:.2f} ms")
                del data
            del params, p32
        cs.torch.cuda.empty_cache()
    return rows


def decode_timing(k) -> dict:
    """Each of chip_smoke.LM_DECODE_CHECK's decode step at phase 13b's
    weights and tokens: host ms a step (median of 3 passes), and one
    profiled pass (``chip_smoke.device_profile``) divided by its steps.
    Every pass starts from the prefill's cache (a step that writes into
    its cache rewrites the slots the pass reads)."""
    rows = {}
    for i, (arch, batch, tokens, images, prec, layers) in enumerate(
            cs.LM_FAMILIES):
        if arch not in cs.LM_DECODE_CHECK:
            continue
        cfg = configs.get_config(arch)
        dt = cs.DTYPES[prec]
        params = k.transformer.init_params(
            cfg, cs.torch.Generator(device="cuda").manual_seed(20 + i),
            device="cuda", dtype=dt)
        toks = cs.lm_inputs(k, cfg, batch, tokens, images, dt,
                            seed=30 + i)["tokens"]
        S, n = toks.shape[1], cs.LM_DECODE_STEPS
        prefill, decode = k.lm.make_serve_fns(cfg)
        _, cache = prefill(params, toks[:, :S - n], S)

        def steps():
            c = cache
            for t in range(S - n, S - n + DECODE_STEPS):
                _, c = decode(params, c, toks[:, t:t + 1])

        host = cs.host_ms(steps, 3) / DECODE_STEPS
        prof = cs.device_profile(steps)
        rows[arch] = {"cache_slots": S, "host_ms_per_step": host,
                      "profiled_wall_ms_per_step":
                          prof["wall_ms"] / DECODE_STEPS,
                      "busy_ms_per_step": prof["busy_ms"] / DECODE_STEPS,
                      "idle_share": prof["idle_share"],
                      "by_kernel_ms": prof["by_kernel_ms"]}
        cs.log("decode", f"{arch} batch {batch}, {S} cache slots: "
               f"{host:.2f} ms a step (host clock), the card busy "
               f"{rows[arch]['busy_ms_per_step']:.3f} ms a step, idle "
               f"{prof['idle_share']:.3f} of the profiled pass")
        del params, toks, cache
        cs.torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    if not cs.torch.cuda.is_available():
        sys.exit("lm_phase: no CUDA device available")
    t0 = time.perf_counter()
    out = {"card": cs.phase_card(), "src": os.path.abspath(args.src)}
    if not args.decode_only:  # the transformers launch no kernel
        cs.phase_build(_build)
    serve_lm = None
    if args.train_only:  # the drivers (an earlier commit has none)
        from repro_torch.examples import serve_lm
    k = argparse.Namespace(conv_ops=conv_ops, bn_ops=bn_ops,
                           pack_ops=pack_ops, ssd_ops=ssd_ops,
                           ssd_ref=ssd_ref, mamba2=mamba2, ssm_lm=ssm_lm,
                           lm=lm, transformer=transformer,
                           frontends=frontends, configs=configs,
                           specs=specs, models=models, flags=flags,
                           tree=tree, Adam=Adam, warmup_cosine=warmup_cosine,
                           launch_train=launch_train, serve_lm=serve_lm,
                           train_step=train_step, mesh_lib=mesh_lib)
    if args.sharded_only:
        from repro_torch.core import param_specs, sharding, spmd
        k.sharding, k.param_specs, k.spmd = sharding, param_specs, spmd
        if args.sharded_run:
            cs.LM_SHARDED = tuple(r for r in cs.LM_SHARDED
                                  if r[0] in args.sharded_run)
        cs.zero_counts(k)
        out["lm_sharded"], launched = cs.phase_lm_sharded(
            k, configs.get_config)
        got = cs.counts(k)
        cs.check(got == dict(cs.NO_LAUNCHES, ssd_scan=launched),
                 f"launches {got}, expected {launched} ssd_scan")
        out["launches"] = got
        print("launches", json.dumps(got))
    elif args.train_only:
        if args.train_arch:
            cs.LM_TRAIN = tuple(r for r in cs.LM_TRAIN
                                if r[0] in args.train_arch)
        cs.zero_counts(k)
        out["lm_train"], launched = cs.phase_lm_train(k, configs.get_config)
        got = cs.counts(k)
        cs.check(got == dict(cs.NO_LAUNCHES, ssd_scan=launched),
                 f"launches {got}, expected {launched} ssd_scan")
        out["launches"] = got
        out["ssd_backward"] = cs.ssd_backward_rows(k)
        print("launches", json.dumps(got))
    elif args.serve_only:
        out["serve"] = serve_timing(k)
    elif args.decode_only:
        with cs.torch.inference_mode():
            out["decode"] = decode_timing(k)
    else:
        if not args.skip_ssd:
            out["ssd_kernel"] = cs.phase_ssd_kernel(ssd_ops, ssd_ref, mamba2)
        zcfg = configs.get_config("zamba2-1.2b")
        cs.zero_counts(k)
        out["lm_families"], forwards = cs.phase_lm_families(
            k, configs.get_config)
        got = cs.counts(k)
        cs.check(got == dict(cs.NO_LAUNCHES,
                             ssd_scan=zcfg.num_layers * forwards),
                 f"launches {got} for {forwards} zamba2 forwards")
        out["launches"] = got
        if not args.skip_ssd:
            out["ssd_scan_zamba2"] = cs.ssd_rows(
                k, cs.SSD_LAYERS["zamba2-1.2b"])
        print("launches", json.dumps(got))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"done in {time.perf_counter() - t0:.0f} s")
