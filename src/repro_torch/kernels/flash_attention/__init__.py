"""Attention forward (prefill) and split-K decode, with GQA, causal and
sliding-window masks and a logit softcap, as hand-written CUDA kernels."""
