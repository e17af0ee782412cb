"""Models: the fused cohort step and the KIV-2 exon path (twin of
``grid_tpu.models``)."""

from grid_tpu_torch.models.kiv import compute_dipcn_for_exon, estimate_kiv2, get_exon_count

__all__ = ["estimate_kiv2", "get_exon_count", "compute_dipcn_for_exon"]
