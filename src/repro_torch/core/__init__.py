"""The paper's primary contribution: subdivision cost model, OLT, ASK.

  cost_model  Eqs. 1-25: W_E/W_SSD, T_SBR/T_MBR, Omega, {g,r,B} search
  olt         offset lookup tables: prefix-sum compaction, subdivision
  ask         Adaptive Serial Kernels: one launch per level (run_ask), the
              level loop as one dispatch (run_ask_fused, run_ask_scan), or
              a batch of frames, each with its own ring
              (run_ask_scan_batch), sharded over a frames mesh
              (run_ask_scan_sharded, ShardedDispatch)
  graphs      CUDA-graph replays of the one-dispatch engines on the card
  pooled      one cross-frame worklist per level for a batch of frames
              (one a shard under a mesh: run_ask_pooled_sharded)
  progressive the split scan: a coarse preview, then the exact canvas
  planner     occupancy-aware capacity planner: per-frame p_subdiv from
              zoom depth, bucketed dispatch, overflow retry
  feedback    measured-occupancy estimator feeding the planner
  dp_emul     Dynamic-Parallelism-style recursive baseline
  ssd_synth   Sec. 7: k-D ASK on synthetic SSD fields (Morton OLT)
  adaptive_attention  beyond the paper: ASK-refined block-sparse decode
              attention over a KV cache
"""

from repro_torch.core import (adaptive_attention, cost_model, feedback, graphs,
                              olt, planner, pooled, progressive)
from repro_torch.core.adaptive_attention import (adaptive_decode_attention,
                                                 build_envelope_pyramid,
                                                 exact_decode_attention)
from repro_torch.core.ask import (ASKProblem, ASKStats, ShardedDispatch,
                                  dispatch_ask_scan_sharded, pad_frames,
                                  run_ask, run_ask_fused, run_ask_scan,
                                  run_ask_scan_batch, run_ask_scan_sharded,
                                  scan_capacities)
from repro_torch.core.dp_emul import run_dp
from repro_torch.core.feedback import OccupancyEstimator
from repro_torch.core.planner import (CapacityPlan, PlanReport,
                                      plan_capacities, solve_planned,
                                      solve_pooled)
from repro_torch.core.pooled import run_ask_pooled, run_ask_pooled_batch

__all__ = ["adaptive_attention", "cost_model", "feedback", "graphs", "olt", "planner", "pooled",
           "progressive", "ASKProblem", "ASKStats", "ShardedDispatch",
           "run_ask", "run_ask_fused",
           "run_ask_scan", "run_ask_scan_batch", "run_ask_scan_sharded",
           "dispatch_ask_scan_sharded", "pad_frames", "scan_capacities",
           "CapacityPlan", "PlanReport", "plan_capacities", "solve_planned",
           "solve_pooled", "OccupancyEstimator", "run_dp", "run_ask_pooled",
           "run_ask_pooled_batch", "build_envelope_pyramid",
           "adaptive_decode_attention", "exact_decode_attention"]
