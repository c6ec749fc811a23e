"""The Mapper's combiner: bucket-accumulate record values by key into a
dense ``(num_buckets, D)`` sum, in one kernel."""
