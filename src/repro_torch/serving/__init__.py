"""The batched LSH service (reference: ``repro.serving``)."""
