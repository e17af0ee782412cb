"""Reading alignment files (BAM/CRAM) for the host steps 1-3."""
