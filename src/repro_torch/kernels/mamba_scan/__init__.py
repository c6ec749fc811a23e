"""The Mamba-1 selective scan over a whole sequence, as a hand-written
CUDA kernel, and its one-token decode step."""
