"""Instance placement: the parallelism ``Layout`` and the worker mesh."""
