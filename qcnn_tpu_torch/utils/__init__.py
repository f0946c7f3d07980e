"""Host-side utilities (timers)."""
