"""Train and eval steps (``train_step``), the sparse GloVe-table optimizer
(``sparse_table``) and data parallelism (``mesh``, ``context``,
``sharding``). The package re-exports nothing: the model's modules import
``parallel.context`` and ``parallel.sharding``, and ``train_step`` imports
the model, so a package that imported the step would import it into a
half-built model module."""
