"""repro_torch.mem — adjoint memory planning.

The paper's contribution is a *tunable* memory/recompute trade (Table 2,
Prop. 2); this package makes the tuning automatic:

  model    analytic per-policy cost model (peak bytes, extra f-evals) and
           its ground truth, one gradient's peak measured on the device;
  planner  ``plan_odeint``: the cheapest reverse-accurate policy under a
           byte budget (drives ``odeint(adjoint="auto", mem_budget=...)``)
           and ``plan_depth_remat`` for the LM stack;
  offload  the checkpoint stores (device, pinned host, spill, disk) that
           ``offload=`` and a plan that spills run on.
"""
from repro_torch.mem.model import (CostEstimate, f_activation_bytes,
                                   max_fitting_ncheck, measure_reverse_cost,
                                   policy_cost, spill_callback_counts,
                                   tree_bytes)
from repro_torch.mem.planner import (CandidateDecision, Plan,
                                     candidate_costs, plan_depth_remat,
                                     plan_odeint)

__all__ = [
    "CostEstimate", "policy_cost", "tree_bytes", "f_activation_bytes",
    "max_fitting_ncheck", "measure_reverse_cost", "spill_callback_counts",
    "CandidateDecision", "Plan", "plan_odeint", "candidate_costs",
    "plan_depth_remat",
]
