"""Training losses (the geometric Lp family so far)."""
