"""PyTorch/CUDA port of the LO-BCQ W4A4 serving path (``repro`` is the
JAX reference).

Module names follow the JAX package one for one (``repro_torch.core.bcq``
is the counterpart of ``repro.core.bcq`` and so on).  The port imports
``torch`` and never ``jax`` or anything of ``repro``; the configs and the
frozen universal codebooks it needs are its own copies under
``repro_torch/configs``.

The two hand-written Hopper kernels live in ``repro_torch/csrc`` and are
built on first use by ``repro_torch.kernels.build``.
"""
