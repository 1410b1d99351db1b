"""Tracing, timing and memory reporting (counterpart of hpgmg_tpu/utils)."""
