"""Hand-written Hopper kernels of the port and their plain versions.

Counterpart of ``repro/kernels``. Each kernel module pairs a CUDA C++
source in ``csrc/`` (built for ``sm_90a`` by ``_build.py`` at first use)
with its plain PyTorch version; ``ref.py`` holds the plain functions and
the rounding contract they share with the kernels, and ``ops.py`` the
public entry points.

  mandelbrot_dwell   flat exhaustive point values (the Ex baseline)
  perimeter_query    Mariani-Silver border query Q
  region_fill        terminal work T
  region_dwell       last-level application work A
  olt_compact        the OLT scan (exclusive prefix sum and total)
  region_fill_pooled / region_dwell_pooled
                     T and A on the pooled engine's banded canvas (the
                     pooled border query lives in perimeter_query)
  moe_dispatch       batched OLT ranks (the MoE position_in_expert)

Routing and scheduling live beside them:

  policy             KernelPolicy: the one routing object (backend
                     torch/cuda/tuned, per-kernel schedule overrides,
                     tuning-cache path) every ops.py entry point accepts
                     as ``policy=``
  autotune           the tuned tier: the schedule sweep (the escape loop's
                     steps per block, Ex's thread block), the JSON tuning
                     cache keyed by the card's capability, the heuristics
"""
