"""The reference's ``distributed/``: the checkpointer (``checkpoint``), the
step watchdog (``fault``) and the logical-axis sharding planner on
``DeviceMesh`` and DTensor placements (``sharding``). Int8 cross-pod
compression, ``ElasticTrainer`` and restoring a checkpoint onto other
shardings wait for ROADMAP queue 1, item 11b."""
