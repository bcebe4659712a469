"""The training data pipeline (``pipeline``: ``SyntheticCorpus``,
``PackedLoader``)."""
