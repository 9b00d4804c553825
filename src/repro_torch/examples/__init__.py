"""The port's examples, run as ``python -m repro_torch.examples.<name>``:
``quickstart``, ``hpcc_suite``, ``serve_lm`` and ``train_lm``."""
