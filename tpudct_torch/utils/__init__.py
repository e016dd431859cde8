"""Host-side helpers of the port (color-space conversion)."""
