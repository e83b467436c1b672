"""Host-side helpers (debug renders)."""
