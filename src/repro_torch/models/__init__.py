"""The LM substrate's models (reference: ``repro.models``): layers,
parameters, attention, CP-SRP LSH attention, MoE, SSD and their assembly."""
