"""The sharded layer (twin of ``grid_tpu.parallel``). Ported so far: the
dispatch policy that decides between the single-card step and the sharded
one (:mod:`.policy`). The mesh, the sharded statistics, the ring kNN and the
sharded cohort step are not ported yet (ROADMAP.md, 'Sharded layer')."""

from grid_tpu_torch.parallel.policy import RING_CROSSOVER_N, choose_cohort_execution

__all__ = ["RING_CROSSOVER_N", "choose_cohort_execution"]
