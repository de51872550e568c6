"""The batched LSH service and the LM serving engine (reference:
``repro.serving``)."""
