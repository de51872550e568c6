"""Logical-axis rules and the mesh placement of the sharded index
(reference: ``repro.distributed``)."""
