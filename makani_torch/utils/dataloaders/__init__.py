"""Host-side data helpers (the parts the training step needs)."""
