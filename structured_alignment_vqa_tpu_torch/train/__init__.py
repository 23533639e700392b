"""Losses, the serving step and the CLI drivers: ``train.predict`` (serving),
``train.evaluate`` (eval), ``train.main`` (the training CLI and its flags)
and ``train.loop`` (the training loop)."""
