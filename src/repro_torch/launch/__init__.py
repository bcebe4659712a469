"""Launchers: ``train`` (the training loop and its CLI, on one device or
sharded over a mesh), ``mesh`` (the production meshes and the fake world
of the dry run) and ``dryrun`` (every cell traced on a production mesh
without allocating)."""
