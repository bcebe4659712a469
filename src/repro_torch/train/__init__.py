"""Training: AdamW (``optimizer``) and the train step (``step``)."""
