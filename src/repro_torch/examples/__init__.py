"""Walkthroughs of the port, each runnable as
``python -m repro_torch.examples.<name> [--device cpu]``."""
