"""Workload configurations the port is measured at."""
