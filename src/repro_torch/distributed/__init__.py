"""The reference's ``distributed/``: sharded checkpoints and their restore
onto other shardings (``checkpoint``), the step watchdog and the elastic
trainer with its fabric wiring (``fault``), int8 cross-pod gradient
compression with error feedback (``compression``) and the logical-axis
sharding planner on ``DeviceMesh`` and DTensor placements
(``sharding``)."""
