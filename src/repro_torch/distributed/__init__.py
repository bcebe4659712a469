"""The single-process parts of the reference's ``distributed/``: the
checkpointer (``checkpoint``) and the step watchdog (``fault``). Sharding,
compression and ``ElasticTrainer`` wait for ROADMAP queue 1, item 11."""
