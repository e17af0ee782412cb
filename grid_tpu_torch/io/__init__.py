"""Host-side input helpers (numpy only)."""
