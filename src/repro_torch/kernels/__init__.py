"""Hand-written Hopper kernels of the port and their plain versions.

Every Pallas kernel of the reference has its counterpart here, in CUDA C++
for sm_90a (``csrc/``): K1 ``saga_correct``, K2 ``partial_sqdist``, K3
``weighted_sum`` (both also batched over receivers), K4
``coordinate_median``, K5 ``trimmed_mean``, K6 ``partial_sqdist_segments``,
K7 ``masked_neighbor_reduce`` and K8 ``flash_attention``.
"""
