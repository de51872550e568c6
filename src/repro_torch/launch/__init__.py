"""Launchers (reference: ``repro.launch``): the local mesh and the
end-to-end training launcher."""
