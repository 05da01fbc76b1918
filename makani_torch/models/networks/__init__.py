"""Networks (only the SFNO is ported so far)."""
