"""Training and evaluation steps (single device in this slice; the NCCL
data-parallel step comes later)."""
