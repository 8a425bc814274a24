"""The paper's primary contribution, as far as the port has come.

  cost_model  Eqs. 1-25: W_E/W_SSD, T_SBR/T_MBR, Omega, {g,r,B} search
  olt         offset lookup tables: prefix-sum compaction, subdivision
  ask         Adaptive Serial Kernels: one launch per level (run_ask), or
              the level loop as one dispatch (run_ask_fused, run_ask_scan)
  graphs      CUDA-graph replays of the one-dispatch engines on the card
  pooled      one cross-frame worklist per level for a batch of frames
  dp_emul     Dynamic-Parallelism-style recursive baseline
"""

from repro_torch.core import cost_model, graphs, olt, pooled
from repro_torch.core.ask import (ASKProblem, ASKStats, run_ask, run_ask_fused,
                                  run_ask_scan, scan_capacities)
from repro_torch.core.dp_emul import run_dp
from repro_torch.core.pooled import run_ask_pooled, run_ask_pooled_batch

__all__ = ["cost_model", "graphs", "olt", "pooled", "ASKProblem", "ASKStats",
           "run_ask", "run_ask_fused", "run_ask_scan", "scan_capacities",
           "run_dp", "run_ask_pooled", "run_ask_pooled_batch"]
