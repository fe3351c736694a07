"""PyTorch/CUDA port of the AULID serving system (``src/repro`` is the JAX
reference it is held against, output for output).

The port imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
the reference package, whose numpy-only modules it keeps as its own copies
under ``core/``.  Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`); on the CPU every kernel
wrapper runs its plain PyTorch version instead of the hand-written CUDA
kernel under ``csrc/``.
"""
