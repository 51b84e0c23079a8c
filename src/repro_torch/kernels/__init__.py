"""Hand-written Hopper kernels of the port and their plain versions.

Ported (CUDA C++ for sm_90a, ``csrc/``): K1 ``saga_correct``, K2
``partial_sqdist``, K3 ``weighted_sum``, K4 ``coordinate_median``, K5
``trimmed_mean`` and K6 ``partial_sqdist_segments``.  K7 and K8 of the
reference's Pallas kernels are still to port (ROADMAP.md Queue B).
"""
