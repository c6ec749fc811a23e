"""The streaming engine's per-micro-batch fold: hash, window fan-out,
late masking and scatter-accumulate into the carry, in one kernel."""
