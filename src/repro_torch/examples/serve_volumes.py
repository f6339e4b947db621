"""Serve 3D volumes through the batched inference harness: build a
forward-only ``InferenceSession`` — fresh, or restored from a training
checkpoint — push a stream of requests through ``serve()``, and print
the throughput against one request at a time and the latency quantiles.

    python -m repro_torch.examples.serve_volumes
    python -m repro_torch.examples.serve_volumes --device cpu --requests 8
    python -m repro_torch.examples.serve_volumes --arch unet3d-256
    python -m repro_torch.examples.serve_volumes --ckpt out/ck --model 2 \\
        --device cuda:0 --max-batch 16

``--model N`` splits each volume's forward over N spatially parallel
shards (a volume too large for one device fits the group).
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.api import RunConfig, compile
from repro_torch.api import cli
from repro_torch.configs.base import ConvNetConfig
from repro_torch.serve import InferenceSession
from repro_torch.serve.session import to_host

# the default demo model: small enough that the per-call overhead
# dominates the forward, so coalescing requests visibly wins
_TINY = ConvNetConfig(name="serve_demo8", family="conv3d",
                      arch="cosmoflow", input_width=8, in_channels=1,
                      out_dim=4, conv_channels=(2, 4), fc_dims=(16, 8))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tiny8",
                    choices=("tiny8", "cosmoflow-512", "unet3d-256"))
    ap.add_argument("--ckpt", default=None,
                    help="restore params from a training checkpoint "
                         "instead of serving a fresh init")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel serving degree")
    ap.add_argument("--model", type=int, default=1,
                    help="spatial-parallel serving degree")
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "fp16"),
                    help="serving precision (masters cast once at load)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome/Perfetto trace of the serve "
                         "spans to PATH")
    cli.add_serve_args(ap)
    cli.add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.ckpt:
        sess = InferenceSession.restore(
            args.ckpt, data=args.data, spatial=args.model,
            precision=args.precision, trace=args.trace,
            **cli.placement(args, args.data * args.model))
    else:
        cfg = (_TINY if args.arch == "tiny8"
               else configs.get_smoke_config(args.arch))
        over = {"precision": args.precision} if args.precision else {}
        if args.trace:
            over["trace"] = args.trace
        config = RunConfig(model=cfg, mode="infer", global_batch=args.data,
                           data=args.data, spatial=args.model, **over)
        sess = compile(config,
                       **cli.placement(args, args.data * args.model))
    print(sess.describe())

    cfg = sess.cfg
    w = cfg.input_width
    r = np.random.RandomState(0)
    reqs = [r.randn(w, w, w, cfg.in_channels).astype(np.float32)
            for _ in range(args.requests)]

    # first use at both batch sizes the run takes (a live server pays
    # this once per batch size)
    to_host(sess.predict(np.stack(reqs[:1])))
    if len(reqs) >= args.max_batch:
        to_host(sess.predict(np.stack(reqs[:args.max_batch])))

    # one request at a time, each reply awaited before the next (what a
    # caller without the harness would do)
    t0 = time.perf_counter()
    for q in reqs:
        to_host(sess.predict(q[None]))
    un_s = time.perf_counter() - t0

    # the batched harness on the same requests
    with sess.serve(**cli.harness_kwargs(args)) as h:
        t0 = time.perf_counter()
        futs = h.submit_many(reqs)
        rows = [f.result(timeout=600) for f in futs]
        b_s = time.perf_counter() - t0
    tele = sess.telemetry()
    print(f"unbatched: {args.requests / un_s:7.1f} req/s")
    print(f"batched:   {args.requests / b_s:7.1f} req/s "
          f"({un_s / b_s:.2f}x; mean fill "
          f"{tele['serve.batch_fill']:.1f}/{args.max_batch})")
    print(f"latency ms: p50 {tele['serve.latency_p50_ms']:.2f}  "
          f"p95 {tele['serve.latency_p95_ms']:.2f}  "
          f"p99 {tele['serve.latency_p99_ms']:.2f}")
    print(f"first reply: shape {rows[0].shape}, dtype {rows[0].dtype}")
    sess.close()
    if args.trace:
        print(f"trace written to {args.trace} (open at ui.perfetto.dev)")


if __name__ == "__main__":
    main()
