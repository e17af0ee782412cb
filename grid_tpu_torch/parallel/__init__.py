"""The sharded layer (twin of ``grid_tpu.parallel``): the dispatch policy
(:mod:`.policy`), the ranks and their collectives (:mod:`.mesh`), the
sharded statistics (:mod:`.pstats`), the ring kNN (:mod:`.pknn`) and the
sharded cohort step (:mod:`.pcohort`). Not ported: the JAX package's
``cohort_sharding``/``replicated_sharding`` (JAX shardings, with no
counterpart for ranks that each hold their block) and
``auto_sharded_cohort_step`` (ROADMAP.md queue 1 item 2)."""

from grid_tpu_torch.parallel.mesh import (
    CohortGroup,
    RankFailure,
    init_distributed,
    run_ranks,
    shard_cohort_inputs,
)
from grid_tpu_torch.parallel.pcohort import rank_cohort_step, sharded_cohort_step
from grid_tpu_torch.parallel.pknn import ring_knn
from grid_tpu_torch.parallel.policy import RING_CROSSOVER_N, choose_cohort_execution
from grid_tpu_torch.parallel.pstats import normalize_cohort_sharded

__all__ = [
    "RING_CROSSOVER_N",
    "choose_cohort_execution",
    "CohortGroup",
    "RankFailure",
    "init_distributed",
    "run_ranks",
    "shard_cohort_inputs",
    "normalize_cohort_sharded",
    "ring_knn",
    "rank_cohort_step",
    "sharded_cohort_step",
]
