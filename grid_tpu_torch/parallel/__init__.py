"""The sharded layer (twin of ``grid_tpu.parallel``): the dispatch policy
(:mod:`.policy`), the ranks and their collectives (:mod:`.mesh`), the
sharded statistics (:mod:`.pstats`), the ring kNN (:mod:`.pknn`) and the
sharded cohort step (:mod:`.pcohort`): the ring form, the ring form on a
cohort the ranks stage themselves, and the gather form
(``auto_sharded_cohort_step``). Not ported: the JAX package's
``cohort_sharding``/``replicated_sharding``, JAX shardings, which ranks that
each hold their own block have no use for."""

from grid_tpu_torch.parallel.mesh import (
    CohortGroup,
    RankFailure,
    init_distributed,
    run_ranks,
    shard_cohort_inputs,
)
from grid_tpu_torch.parallel.pcohort import (
    auto_sharded_cohort_step,
    rank_auto_cohort_step,
    rank_cohort_step,
    sharded_cohort_step,
    staged_sharded_cohort_step,
)
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
    "staged_sharded_cohort_step",
    "rank_auto_cohort_step",
    "auto_sharded_cohort_step",
]
