"""PyTorch/CUDA port of the Byzantine-robust federated SAGA system.

The JAX package :mod:`repro` is the reference; this package mirrors its
layout module by module (``configs/``, ``core/``, ``data/``, ``kernels/``,
``launch/``, ``models/``, ``optim/``, ``telemetry/``, ``topology/``) and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Besides
the robust federation, it serves the dense decoders of ``configs/``
(``python -m repro_torch.launch.serve --arch qwen2-7b``): prefill through
kernel K8, then greedy decode over the KV cache.  It imports ``torch`` and
``numpy`` only -- never ``jax`` and nothing of :mod:`repro`.

Every entry point takes an explicit ``device`` (default ``"cuda"``).  On a
CUDA device the hot path runs the hand-written Hopper kernels of
:mod:`repro_torch.kernels`; ``device="cpu"`` runs their plain PyTorch
versions (the port's oracle).  Without a card, asking for ``"cuda"``
raises instead of dropping to the CPU.
"""
