"""Losses, the serving step and the CLI drivers: ``train.predict`` (serving),
``train.evaluate`` (eval), ``train.main`` (the flags) and ``train.loop``."""
