"""Per-metric readers: ``<base>.py`` reads every metric named ``<base>``
or ``<base>.<suffix>`` from a run's record with ``read(record)``, and
returns None where the run gives it nothing to read."""
