"""PyTorch/CUDA port of ``repro``, the hybrid-parallel 3-D CNN system of
"The Case for Strong Scaling in Deep Learning" (CosmoFlow, 3D U-Net).

It keeps the reference package's sub-package layout and names (``api``,
``configs``, ``core``, ``data``, ``kernels``, ``models``, ``obs``,
``serve``, ``train``) and its data layouts (NDHWC activations, DHWIO conv weights),
and replaces each Pallas kernel with a CUDA kernel for Hopper
(``csrc/``). It imports ``torch``, never ``jax`` nor ``repro``. Entry
point: ``repro_torch.api.compile``.
"""
