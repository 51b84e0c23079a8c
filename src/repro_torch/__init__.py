"""PyTorch/CUDA port of the Byzantine-robust federated SAGA system.

The JAX package :mod:`repro` is the reference; this package mirrors its
layout module by module (``core/``, ``data/``, ``kernels/``, ``optim/``,
``telemetry/``, ``models/``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and
``numpy`` only -- never ``jax`` and nothing of :mod:`repro`.

Every entry point takes an explicit ``device`` (default ``"cuda"``).  On a
CUDA device the hot path runs the hand-written Hopper kernels of
:mod:`repro_torch.kernels`; ``device="cpu"`` runs their plain PyTorch
versions (the port's oracle).  Without a card, asking for ``"cuda"``
raises instead of dropping to the CPU.
"""
