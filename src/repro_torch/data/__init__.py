"""Synthetic training and serving data (reference: ``repro.data``)."""
