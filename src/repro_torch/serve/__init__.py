"""Inference serving of 3-D volumes on the card: ``InferenceSession``
(forward-only sessions compiled from ``RunConfig(mode="infer")`` or
restored from reference training checkpoints) and ``ServingHarness``
(the batched request queue its ``.serve()`` starts)."""
from repro_torch.serve.harness import ServingHarness
from repro_torch.serve.session import InferenceSession, InferReport, compile_infer

__all__ = ["InferenceSession", "InferReport", "ServingHarness",
           "compile_infer"]
