"""Launchers: ``train`` (the training loop and its CLI). ``dryrun`` and
``mesh`` lower cells on production meshes and wait for ``distributed/``
(ROADMAP queue 1, item 11)."""
