"""The port's public API: one call from a declarative config to a live
session on the card.

    from repro_torch.api import RunConfig, compile

    sess = compile(RunConfig(model="cosmoflow-512", mode="infer",
                             global_batch=1))
    preds = sess.predict(volumes)        # (N, 512, 512, 512, 4) NDHWC

``compile`` dispatches on ``RunConfig.mode``: ``"infer"`` returns a
forward-only ``repro_torch.serve.InferenceSession`` (``predict``,
``evaluate``, ``serve``, ``restore`` from a reference training
checkpoint); ``"train"`` returns a training ``Session`` on one device
(``step``, ``evaluate``, ``save``, ``Session.restore``):

    sess = compile(RunConfig(model="cosmoflow-128", mode="train",
                             global_batch=4))
    loss = sess.step(volumes, targets)   # one Adam step

For a long run, ``repro_torch.api.supervisor.run(config, steps)`` wraps
the training ``Session`` in the recovery loop: guarded steps, a step
watchdog, keep-last-K checkpoints, auto-resume from the newest valid
one, and re-degreeing when the device count shrinks.
"""
from repro_torch.api import supervisor
from repro_torch.api.config import RunConfig, RunConfigError
from repro_torch.api.session import Session, compile
from repro_torch.api.supervisor import SupervisorReport

__all__ = ["RunConfig", "RunConfigError", "Session", "SupervisorReport",
           "compile", "supervisor"]
