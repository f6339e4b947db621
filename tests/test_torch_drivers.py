"""The port's drivers against the reference's, on the CPU: the shared
command line (``repro_torch.api.cli``), the CosmoFlow example's preset
(``configs.cosmoflow.big_config`` / ``run_preset``), the analytic FLOPs
(``launch.specs``), and the launcher and the four examples run for 2
steps with ``--device cpu``.

* ``config_from_args`` gives the reference's ``RunConfig`` (its JSON)
  for a set of argument lists over each preset; ``harness_kwargs`` the
  same keywords; ``--pipeline 2`` trains two device groups (with one data
  shard a group), and without enough data shards raises
  ``RunConfigError`` naming the data degree;
* ``big_config`` and ``run_preset`` equal the reference's at several
  widths;
* ``conv_net_flops_per_sample`` (forward and training) and
  ``model_flops`` equal the reference's for every conv architecture,
  full and smoke, and the big variants;
* ``python -m repro_torch.launch.train`` and
  ``python -m repro_torch.examples.<name>`` (their ``main``) run at
  smoke size for 2 steps; an LM ``--arch`` with ``--data`` or
  ``--model`` above 1 raises naming the sharded LM slice (its unsharded
  training: ``tests/test_torch_lm_train.py``).
"""
import argparse
import dataclasses
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import cli as jcli
from repro.configs import cosmoflow as jcosmo_cfg
from repro.configs import unet3d as junet_cfg
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.api import RunConfigError, cli, compile
from repro_torch.configs import cosmoflow as cosmo_cfg
from repro_torch.configs import unet3d as unet_cfg
from repro_torch.examples import (quickstart, serve_volumes, train_cosmoflow,
                                  train_unet3d)
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train

from conftest import REPO, SRC

ARGVS = [
    [],
    ["--steps", "7", "--batch", "8", "--data", "2", "--model", "4"],
    ["--plan", "--precision", "bf16", "--grad-comm", "reduce_scatter"],
    ["--memory-budget", "1.5", "--grad-clip", "0.5", "--ckpt", "out/ck",
     "--trace", "out/t.json", "--metrics", "out/m.jsonl"],
    ["--pipeline", "2", "--micro-batches", "8",
     "--pipeline-schedule", "sequential"],
    ["--model", "2", "--grad-clip", "0"],
]
PRESETS = [("cosmoflow", lambda: cosmo_cfg.run_preset(32),
            lambda: jcosmo_cfg.run_preset(32)),
           ("unet3d", unet_cfg.run_preset, junet_cfg.run_preset)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _parsed(add, argv):
    ap = argparse.ArgumentParser()
    add(ap)
    return ap.parse_args(argv)


@pytest.mark.parametrize("preset", [p[0] for p in PRESETS])
@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_config_from_args_matches_reference(preset, i):
    _, port_base, ref_base = next(p for p in PRESETS if p[0] == preset)
    got = cli.config_from_args(port_base(),
                               _parsed(cli.add_session_args, ARGVS[i]))
    want = jcli.config_from_args(ref_base(),
                                 _parsed(jcli.add_session_args, ARGVS[i]))
    assert got.to_json() == want.to_json()


def test_flags_are_the_references_and_device():
    port = _parsed(cli.add_session_args, ["--device", "cpu"])
    ref = _parsed(jcli.add_session_args, [])
    assert set(vars(port)) == set(vars(ref)) | {"device"}
    assert port.device == "cpu"
    assert _parsed(cli.add_session_args, []).device is None  # the card


@pytest.mark.parametrize("argv", [[], ["--max-batch", "4", "--max-wait-ms",
                                       "0.5", "--max-queue", "9",
                                       "--workers", "3"]])
def test_harness_kwargs_match_reference(argv):
    assert cli.harness_kwargs(_parsed(cli.add_serve_args, argv)) == \
        jcli.harness_kwargs(_parsed(jcli.add_serve_args, argv))


def test_pipeline_flag_raises_naming_the_pipeline_slice():
    """``--pipeline 2`` acts: alone (one data shard for two groups) it
    raises naming the data degree and the pipeline; with ``--data 2``
    and no clip it compiles two device groups that train."""
    config = cli.config_from_args(
        cosmo_cfg.run_preset(32),
        _parsed(cli.add_session_args, ["--pipeline", "2"]))
    with pytest.raises(RunConfigError, match="pipeline=2") as e:
        config.validate(device_count=None)
    assert e.value.field == "data"
    args = _parsed(cli.add_session_args,
                   ["--pipeline", "2", "--data", "2", "--grad-clip", "0",
                    "--micro-batches", "2", "--device", "cpu"])
    config = cli.config_from_args(
        dataclasses.replace(cosmo_cfg.run_preset(32), model=cosmo_cfg.SMOKE),
        args)
    with compile(config, **cli.placement(args, 2)) as sess:
        assert sess.plan.n_groups == 2
        x = np.random.RandomState(0).randn(4, 32, 32, 32, 2)
        assert torch.isfinite(sess.step(x.astype(np.float32),
                                        np.zeros((4, 4), np.float32)))


@pytest.mark.parametrize("shards,argv,want", [
    (1, [], {}), (1, ["--device", "cpu"], {"device": "cpu"}),
    (4, ["--device", "cuda:0"], {"devices": ["cuda:0"] * 4}), (4, [], {})])
def test_placement(shards, argv, want):
    assert cli.placement(_parsed(cli.add_device_arg, argv), shards) == want


# ------------------------------------------------------ the presets ----
@pytest.mark.parametrize("width", [16, 64, 128])
def test_big_config_and_run_preset_match_reference(width):
    got, want = cosmo_cfg.big_config(width), jcosmo_cfg.big_config(width)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert cosmo_cfg.run_preset(width).to_json() == \
        jcosmo_cfg.run_preset(width).to_json()
    assert cosmo_cfg.big_config().name == "cosmoflow-big-64"


# ---------------------------------------------------------- FLOPs ----
def _conv_configs():
    out = []
    for arch in configs.COSMOFLOW_ARCHS + configs.UNET_ARCHS:
        out.append((arch, configs.get_config(arch),
                    jconfigs.get_config(arch)))
        out.append((arch, configs.get_smoke_config(arch),
                    jconfigs.get_smoke_config(arch)))
    for w in (16, 64, 128):
        out.append(("cosmoflow-big", cosmo_cfg.big_config(w),
                    jcosmo_cfg.big_config(w)))
    return out


@pytest.mark.parametrize("i", range(len(_conv_configs())))
def test_flops_match_reference(i):
    arch, cfg, jcfg = _conv_configs()[i]
    for fwd in (False, True):
        assert specs.conv_net_flops_per_sample(cfg, forward_only=fwd) == \
            jspecs.conv_net_flops_per_sample(jcfg, forward_only=fwd)
    assert specs.model_flops(arch, cfg, "train_4k") == \
        jspecs.model_flops(arch, jcfg, "train_4k")


@pytest.mark.parametrize("shape", list(configs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", configs.LM_ARCHS)
def test_lm_flops_match_reference(arch, shape):
    """The 6ND / 2ND convention over the input shapes, for every LM."""
    assert specs.model_flops(arch, configs.get_config(arch), shape) == \
        jspecs.model_flops(arch, jconfigs.get_config(arch), shape)


# ------------------------------------------ launcher and examples ----
def _losses(text: str):
    vals = [float(v) for v in re.findall(
        r"(?:loss|voxel CE) (-?[0-9.]+|nan|inf)", text)]
    assert vals and all(math.isfinite(v) for v in vals), text
    return vals


def test_launcher_trains_two_steps(capsys):
    launch_train.main(["--arch", "cosmoflow-512", "--steps", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cosmoflow-smoke" in out and "step    1" in out
    assert len(_losses(out)) == 2


def test_launcher_rejects_an_lm_naming_the_lm_slice(capsys, monkeypatch):
    """A language model trains unsharded (tests/test_torch_lm_train.py)
    or over ``--data`` x ``--model`` shards of one device under
    ``--plan`` (tests/test_torch_lm_sharded.py; by default the arch's
    training plan, ``configs.plan_for``); the conv nets' pipeline
    groups, micro-batches and gradient lowerings raise (the reference's
    LM loop takes none of them), and so does a process a shard
    (``torchrun``: the next slice)."""
    for argv in (["--pipeline", "2"], ["--micro-batches", "2"],
                 ["--grad-comm", "overlap"]):
        with pytest.raises(NotImplementedError, match="conv-net options"):
            launch_train.main(["--arch", "mamba2-370m", "--device", "cpu",
                               *argv])
    launch_train.main(["--arch", "mamba2-370m", "--device", "cpu",
                       "--data", "2", "--model", "2", "--plan", "cp",
                       "--steps", "1", "--seq", "16"])
    assert "plan cp, mesh 2x2" in capsys.readouterr().out
    # no --plan: the arch's training plan (configs.plan_for)
    launch_train.main(["--arch", "gemma2-2b", "--device", "cpu", "--model",
                       "2", "--steps", "1", "--seq", "16"])
    assert "plan cp, mesh 1x2" in capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="next slice"):
        launch_train.main(["--arch", "mamba2-370m", "--device", "cpu",
                           "--model", "2"])


def test_quickstart_runs_two_steps(capsys):
    quickstart.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(_losses(out)) == 2 and out.rstrip().endswith("done.")


def test_train_cosmoflow_example_runs_two_steps(capsys, tmp_path):
    ckpt = str(tmp_path / "ck")
    train_cosmoflow.main(["--device", "cpu", "--width", "16", "--steps",
                          "2", "--num-train", "4", "--eval-every", "2",
                          "--batch", "2", "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "cosmoflow-big-16" in out and "eval mse" in out
    assert f"checkpoint -> {ckpt}" in out and len(_losses(out)) == 1


def test_train_unet3d_example_runs_two_steps(capsys):
    train_unet3d.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "unet3d-smoke" in out and len(_losses(out)) == 1
    assert out.rstrip().endswith("done.")


def test_serve_volumes_example_serves(capsys):
    serve_volumes.main(["--device", "cpu", "--requests", "8",
                        "--max-batch", "4"])
    out = capsys.readouterr().out
    assert "batched:" in out and "first reply: shape (4,)" in out


def test_examples_run_as_modules():
    """``python -m repro_torch.examples.quickstart`` as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--steps",
         "2", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr
    assert len(_losses(proc.stdout)) == 2
