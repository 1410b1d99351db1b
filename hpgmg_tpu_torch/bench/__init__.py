"""Benchmark driver and its command-line entry (``python -m hpgmg_tpu_torch.bench``)."""
