"""Training on the LM substrate (reference: ``repro.training``): AdamW, the
train step with remat and gradient accumulation, the paper's CP-sketch
gradient compression, checkpoints and the fault-tolerant loop."""
