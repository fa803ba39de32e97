"""Scripts of the port run from the repository root (kernel A/B timing, the
accuracy protocol); ``acc_run`` is also imported by ``chip_smoke.py``."""
